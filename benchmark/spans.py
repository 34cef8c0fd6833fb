"""The port's spans against the card's trace, for the per-layer metrics
that read them and for the table of where the card waits.

A traced window (`--trace 1`) runs under `torch.profiler`, and while it
runs the port records its spans (`tinyram_tpu_torch.utils.profiling`):
each prover phase as "prover.<phase>", and leaf spans below them ("ntt",
"msm", "lookup.permute", "witness.fixed", ...), each entry (name, phase,
start, end) on `time.perf_counter`, the clock `trace.py` puts the card's
operations on.  Every prover phase ends in a synchronize, so the card's
busy time inside a phase span is that phase's device time and the rest is
the host's.  Leaf spans do not synchronize: they say what the host was
doing while the card waited.

A checkout whose port has no span log (or whose log dropped entries in the
window) gives no leaf spans: `port_spans` returns None, and so do the
metrics that need them.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

runs one traced window of a cell on the card (no check) and prints one
JSON line: its per-layer metrics, the host/device split of every phase a
request, and the card's idle seconds a request by the innermost leaf span
that held the host.
"""

from __future__ import annotations

import bisect

PHASE = "prover."  # the prefix of the port's phase spans


class Busy:
    """The card's busy seconds over any interval, from a profile's union
    of device intervals (`trace.Profile.busy`, sorted and disjoint)."""

    def __init__(self, profile):
        self.starts = [s for s, _ in profile.busy]
        self.ends = [e for _, e in profile.busy]
        self.before = [0.0]  # busy seconds before interval i starts
        for s, e in profile.busy:
            self.before.append(self.before[-1] + (e - s))

    def upto(self, t: float) -> float:
        """Busy seconds before time t."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]

    def between(self, start: float, end: float) -> float:
        return max(0.0, self.upto(end) - self.upto(start))


def seconds(profile, spans) -> list[tuple[float, float]]:
    """(wall, busy) seconds of each span, a harness span (name, start,
    end) or a port's entry (name, phase, start, end): busy is the union of
    `profile.ops` clipped to the span."""
    busy = Busy(profile)
    return [(sp[-1] - sp[-2], busy.between(sp[-2], sp[-1])) for sp in spans]


def _window(req) -> tuple[float, float]:
    return req.spans[0][1], req.spans[-1][2]


def port_spans(run) -> list[tuple] | None:
    """The port's entries that lie inside the window's completed requests,
    or None: no trace, no span log in the port, nothing logged, or the log
    dropped entries at its bound that may have been the window's (unless
    the oldest it kept ended before the window, all of them)."""
    p = run.profile
    if p is None or not run.completed:
        return None
    try:
        from tinyram_tpu_torch.utils import profiling

        read, dropped = profiling.spans, profiling.dropped
    except (ImportError, AttributeError):
        return None
    logged = read()
    # the log holds entries in the order they ended and drops the oldest:
    # none of the window is lost if the oldest kept one ended before it
    if dropped() and (not logged or logged[0][3] > p.t0):
        return None
    windows = sorted(_window(r) for r in run.completed)
    starts = [w[0] for w in windows]
    out = []
    for e in read(p.t0, p.t1):
        i = bisect.bisect_right(starts, e[2]) - 1
        if i >= 0 and e[3] <= windows[i][1]:
            out.append(e)
    return out or None


def per_request_seconds(run, names) -> float | None:
    """Wall seconds a completed request of the port's spans named
    `names`, or None without them."""
    entries = port_spans(run)
    if entries is None:
        return None
    return sum(e[3] - e[2] for e in entries
               if e[0] in names) / len(run.completed)


def phase_seconds(run, *phases) -> float | None:
    """Wall seconds a completed request of the harness's spans
    "prover.<phase>" named, or None where no request has one."""
    names = {PHASE + ph for ph in phases}
    done = run.completed
    if not done or not any(sp[0] in names for r in done for sp in r.spans):
        return None
    return run.per_request(*names)


def phase_busy(run, *phases) -> float | None:
    """The card's busy seconds a completed request inside the harness's
    spans "prover.<phase>" named (the phases end in a synchronize, so this
    is their device time), or None without a trace."""
    if run.profile is None or not run.profile.busy:
        return None
    names = {PHASE + ph for ph in phases}
    spans = [sp for r in run.completed for sp in r.spans if sp[0] in names]
    if not spans:
        return None
    return sum(b for _, b in seconds(run.profile, spans)) / len(run.completed)


def _segments(leaves: list, t0: float, t1: float, cuts=()) -> list[tuple]:
    """[t0, t1] cut at `cuts` and at every leaf's start and end: [(a, b,
    the innermost leaf holding [a, b] or None)].  Spans of one thread
    nest, so the innermost is the one that started last."""
    leaves = sorted(leaves, key=lambda e: (e[2], -e[3]))
    cuts = sorted({t0, t1, *(x for x in cuts if t0 < x < t1),
                   *(x for e in leaves for x in (e[2], e[3]) if t0 < x < t1)})
    out, stack, i = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        stack = [e for e in stack if e[3] > a]
        while i < len(leaves) and leaves[i][2] <= a:
            if leaves[i][3] > a:
                stack.append(leaves[i])
            i += 1
        out.append((a, b, stack[-1] if stack else None))
    return out


def _label(req, t: float) -> str:
    for name, s, e in req.spans:
        if s <= t <= e:
            return name[len(PHASE):] if name.startswith(PHASE) else name
    return "between spans"


def breakdown(run) -> dict | None:
    """Where a completed request's time went, a request on average:
    `phases`, each harness span's wall and busy seconds ("emulate",
    "witness", "prover.<phase>"); `leaves`, each leaf's wall and busy
    seconds by "<phase> / <name>" (a leaf's nested leaves included); `idle`,
    the card's idle seconds put down to the innermost leaf that held the
    host ("<phase> / <name>"), or to the harness span with no leaf under
    it ("<span> / -"); `idle_s` and `idle_in_leaves_s`, the idle seconds
    inside requests and the part a leaf held.  None without the port's
    spans."""
    entries = port_spans(run)
    if entries is None:
        return None
    done = run.completed
    busy = Busy(run.profile)
    count = len(done)
    phases: dict = {}
    leaves: dict = {}
    idle: dict = {}
    ordered = sorted(done, key=_window)
    starts = [_window(r)[0] for r in ordered]
    by_req: dict = {id(r): [] for r in done}
    for e in entries:
        if not e[0].startswith(PHASE):
            req = ordered[bisect.bisect_right(starts, e[2]) - 1]
            by_req[id(req)].append(e)

    def add(table, key, wall, dev):
        w, b = table.get(key, (0.0, 0.0))
        table[key] = (w + wall / count, b + dev / count)

    for req in done:
        for name, s, e in req.spans[:-1]:  # the last: "proof end", empty
            add(phases, name, e - s, busy.between(s, e))
        t0, t1 = _window(req)
        for e in by_req[id(req)]:
            where = _label(req, (e[2] + e[3]) / 2)
            add(leaves, f"{where} / {e[0]}", e[3] - e[2],
                busy.between(e[2], e[3]))
        edges = [x for _, s, e in req.spans for x in (s, e)]
        for a, b, leaf in _segments(by_req[id(req)], t0, t1, edges):
            gap = (b - a) - busy.between(a, b)
            where = _label(req, (a + b) / 2)
            key = f"{where} / {leaf[0] if leaf else '-'}"
            idle[key] = idle.get(key, 0.0) + gap / count
    idle_s = sum(idle.values())
    held = sum(v for k, v in idle.items() if not k.endswith(" / -"))
    return {
        "requests": count,
        "phases": {k: {"wall_s": w, "busy_s": b}
                   for k, (w, b) in phases.items()},
        "leaves": {k: {"wall_s": w, "busy_s": b}
                   for k, (w, b) in sorted(leaves.items(),
                                           key=lambda kv: -kv[1][0])},
        "idle": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "idle_s": idle_s,
        "idle_in_leaves_s": held,
    }


def main(argv: list[str]) -> int:
    import argparse
    import json

    from benchmark import run as _command  # noqa: F401  its environment

    from . import harness, programs
    from .reference.tinyram_cs import TinyRamCS
    from .spec import Spec
    from .trace import Recorder

    ap = argparse.ArgumentParser(
        prog="python3 -m benchmark.spans",
        description="One traced window of a cell (no check): its per-layer "
                    "metrics and where its requests' time went.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = Spec.load()
    cell = harness.Cell(spec, args.workload)
    cell.warm_up(args.seed)
    config = cell.config
    run = harness.Run(config, TinyRamCS(config["word_bits"],
                                        config["reg_count"],
                                        k=config["k"]).cs, args.seconds)
    harness.window(cell.system, programs.Client(config, cell.traffic,
                                                args.seed), run, Recorder())
    metrics = {m["name"]: spec.reader(m["name"])(run)
               for m in spec.metrics(args.workload, trace=True)}
    out = {"workload": args.workload, "seed": args.seed,
           "attempted": len(run.requests), "metrics": metrics,
           "request_s": [r.seconds for r in run.completed],
           "breakdown": breakdown(run), **harness.card()}
    print(json.dumps(out))
    return 0 if out["breakdown"] is not None else 1


if __name__ == "__main__":
    import sys

    sys.exit(main(sys.argv[1:]))
