"""The device's side of a traced window, from `torch.profiler`'s CUDA
activity: every operation's interval on the card, put on the host's
clock by a marker kernel launched at a known host time.

From it: the busy time (the union of the intervals, not their sum), the
device time of kernels by name, the operations that took the most time,
and the idle gaps, each labelled by the host span it fell in (the
harness's emulate and witness spans, the prover's phases from
`create_proof(phase_hook=)`)."""

from __future__ import annotations

import bisect
import re
import time

MARKER_CYCLES = 1000


def _ns(event, stem: str) -> float:
    if hasattr(event, f"{stem}_ns"):
        return float(getattr(event, f"{stem}_ns")())
    return 1e3 * float(getattr(event, f"{stem}_us")())


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces of no name,
    template arguments and parameter list."""
    text = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in text:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).strip()[:100] or name[:100]


class Recorder:
    """Records the device's operations over a window (`start`, `stop`)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t_mark = None

    def start(self) -> None:
        import torch

        self.prof.start()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)

    def stop(self) -> list[tuple]:
        """[(name, start, end)] of the device's operations after the marker,
        in seconds of `time.perf_counter`, sorted by start."""
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.prof.stop()
        raw = [e for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        raw.sort(key=lambda e: _ns(e, "start"))
        if not raw:
            return []
        marker = next((e for e in raw if "sleep" in e.name().lower()
                       or "spin" in e.name().lower()), raw[0])
        t0 = _ns(marker, "start")
        out = []
        for e in raw:
            start = _ns(e, "start")
            if e is marker or start < t0:
                continue
            s = self.t_mark + (start - t0) / 1e9
            out.append((e.name(), s, s + _ns(e, "duration") / 1e9))
        return out


class Profile:
    """The device's operations in a window [t0, t1] and the host's spans."""

    def __init__(self, ops: list[tuple], t0: float, t1: float,
                 spans: list[tuple]):
        self.ops = [(n, max(s, t0), min(e, t1)) for n, s, e in ops
                    if e > t0 and s < t1]
        self.t0, self.t1 = t0, t1
        self.spans = sorted(spans, key=lambda sp: sp[1])
        self._starts = [sp[1] for sp in self.spans]
        self.busy = self._union()

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def _union(self) -> list[tuple]:
        merged = []
        for _, s, e in sorted(self.ops, key=lambda op: op[1]):
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def seconds_of(self, names) -> float:
        """Device seconds of the operations whose name holds one of
        `names`."""
        return sum(e - s for n, s, e in self.ops
                   if any(k in n for k in names))

    def top_ops(self, count: int = 10) -> list[list]:
        by_name: dict = {}
        for n, s, e in self.ops:
            key = short_name(n)
            by_name[key] = by_name.get(key, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
        return [[n, s] for n, s in top]

    def label(self, t: float) -> str:
        """The host span that holds time t ("between requests" if none);
        the spans do not overlap."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.spans[i][1] <= t <= self.spans[i][2]:
            return self.spans[i][0]
        return "between requests"

    def idle_gaps(self, count: int = 10) -> list[list]:
        """The longest idle intervals of the device, each labelled by the
        host span its middle fell in."""
        gaps, last = [], self.t0
        for s, e in self.busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.t1 > last:
            gaps.append((last, self.t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.label((s + e) / 2), e - s] for s, e in gaps[:count]]
