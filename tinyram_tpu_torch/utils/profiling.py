"""Tracing / profiling utilities.

The reference has no tracing at all (SURVEY.md §5: closest thing is gate
names for MockProver errors).  Here:

  * `span(name)`: a context manager that records (name, phase, start,
    end) into a bounded log (`SpanLog`), on `time.perf_counter`, the clock
    a traced benchmark run puts the card's operations on.  It records only
    while a `torch.profiler` session runs or inside `recording()`;
    otherwise it is one check and a return.  It never synchronizes the
    card.  `phase` is the prover phase the span ran in ("prover.<name>",
    set by `plonk/prover.py` `_Phases`), or None.  `spans(t0, t1)` reads
    the entries inside a window, `dropped()` counts those the bound lost.
  * `KernelCounters` accumulates per-name op counts and elapsed time.  The
    prover files its phases here as "prover.<phase>" (kernel launches,
    seconds); the mesh's collectives count here too ("mesh.<kind>": the
    field elements a rank sent, `shard/mesh.py`), and the prover files
    them per phase.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field

from torch.autograd import _profiler_enabled

LOG_SIZE = 1 << 16  # entries the span log keeps; older ones are dropped


@dataclass
class KernelCounters:
    ops: dict = field(default_factory=lambda: defaultdict(int))
    seconds: dict = field(default_factory=lambda: defaultdict(float))

    def add(self, name: str, n_ops: int, seconds: float) -> None:
        self.ops[name] += n_ops
        self.seconds[name] += seconds

    def report(self) -> dict:
        return {
            name: {"ops": self.ops[name],
                   "seconds": round(self.seconds[name], 4)}
            for name in sorted(self.ops)
        }

    def snapshot(self, prefix: str) -> dict:
        """{name: (ops, seconds)} of the counters whose name starts with
        `prefix` (a later snapshot minus this one is what ran between)."""
        return {name: (n, self.seconds[name]) for name, n in self.ops.items()
                if name.startswith(prefix)}


counters = KernelCounters()


class _Off:
    """The span handed out while nothing records: enters and exits."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("log", "name", "start")

    def __init__(self, log: "SpanLog", name: str):
        self.log, self.name = log, name

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.log.record(self.name, self.start, time.perf_counter())
        return False


class SpanLog:
    """The last `size` spans, oldest first (in the order they ended), each
    (name, phase, start, end) in seconds of `time.perf_counter`."""

    def __init__(self, size: int = LOG_SIZE):
        self.entries: deque = deque(maxlen=size)
        self.lost = 0  # entries dropped at the bound
        self.phase: str | None = None  # the prover phase running now
        self.forced = 0  # open `recording()` blocks

    def on(self) -> bool:
        """Whether spans record now: inside `recording()`, or while a
        `torch.profiler` session runs on this thread."""
        return self.forced > 0 or _profiler_enabled()

    def span(self, name: str):
        """A context manager recording `name` around its block when `on`."""
        if not self.forced and not _profiler_enabled():
            return _OFF
        return _Span(self, name)

    def record(self, name: str, start: float, end: float) -> None:
        """Append one entry, in the running phase."""
        if len(self.entries) == self.entries.maxlen:
            self.lost += 1
        self.entries.append((name, self.phase, start, end))

    def spans(self, t0: float = float("-inf"),
              t1: float = float("inf")) -> list[tuple]:
        """The entries that started at or after t0 and ended by t1."""
        return [e for e in self.entries if e[2] >= t0 and e[3] <= t1]

    @contextlib.contextmanager
    def recording(self):
        """Record every span inside the block, with no profiler running."""
        self.forced += 1
        try:
            yield self
        finally:
            self.forced -= 1

    def clear(self) -> None:
        self.entries.clear()
        self.lost = 0


log = SpanLog()
span = log.span
spans = log.spans
recording = log.recording


def dropped() -> int:
    """Entries the process's span log has dropped at its bound."""
    return log.lost
