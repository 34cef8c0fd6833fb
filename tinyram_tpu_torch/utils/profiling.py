"""Tracing / profiling utilities.

The reference has no tracing at all (SURVEY.md §5: closest thing is gate
names for MockProver errors).  Here:

  * `profile_region(name)` wraps `torch.profiler.record_function` plus
    wall-clock accounting, so prover phases show up both in profiler
    traces (`torch.profiler.profile`) and in the in-process counters.
  * `KernelCounters` accumulates per-kernel op counts and elapsed time and
    reports ops/s — the per-kernel reporting BASELINE.md asks for.  The
    mesh's collectives count here too ("mesh.<kind>": the field elements a
    rank sent, `shard/mesh.py`), and the prover files them per phase.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class KernelCounters:
    ops: dict = field(default_factory=lambda: defaultdict(int))
    seconds: dict = field(default_factory=lambda: defaultdict(float))

    def add(self, name: str, n_ops: int, seconds: float) -> None:
        self.ops[name] += n_ops
        self.seconds[name] += seconds

    def report(self) -> dict:
        return {
            name: {
                "ops": self.ops[name],
                "seconds": round(self.seconds[name], 4),
                "ops_per_s": round(self.ops[name] / self.seconds[name])
                if self.seconds[name] > 0 else None,
            }
            for name in sorted(self.ops)
        }

    def snapshot(self, prefix: str) -> dict:
        """{name: (ops, seconds)} of the counters whose name starts with
        `prefix` (a later snapshot minus this one is what ran between)."""
        return {name: (n, self.seconds[name]) for name, n in self.ops.items()
                if name.startswith(prefix)}


counters = KernelCounters()


@contextlib.contextmanager
def profile_region(name: str, n_ops: int = 0, counter: KernelCounters = None):
    """Annotate a region for torch.profiler and accumulate ops/s counters."""
    import torch.profiler as _prof

    ann = _prof.record_function(name)
    t0 = time.time()
    with ann:
        yield
    (counter or counters).add(name, n_ops, time.time() - t0)
