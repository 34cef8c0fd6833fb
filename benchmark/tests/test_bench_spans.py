"""`spans.py` on a made-up traced window: device operations nested,
overlapping and crossing a span's edge, the port's leaf spans nested, a
failed request and entries outside the window; every number against a
count made by hand (see the comments)."""

import pytest

from benchmark import harness, spans
from benchmark.spec import Spec
from benchmark.trace import Profile
from tinyram_tpu_torch.utils import profiling

COMMIT = "prover.commit instance+advice"
INTERP = "prover.interpolate instance+advice"

# the card: k2 nested in k1, k3 across interpolate | commit, k4 and k5
# overlapping, k6 in the failed request, k9 across the window's end
OPS = [("k1", 1.5, 2.5), ("k2", 2.0, 2.2), ("k3", 3.5, 4.5),
       ("k4", 5.0, 6.0), ("k5", 5.5, 6.5), ("k6", 9.2, 9.8),
       ("k7", 12.5, 13.0), ("k8", 14.0, 15.0), ("k9", 19.5, 21.0)]
# the harness's spans: requests A [0, 8] and C [10, 17] proved, B failed
REQUESTS = [
    [("emulate", 0, 1), ("witness", 1, 3), (INTERP, 3, 4), (COMMIT, 4, 8),
     ("proof end", 8, 8)],
    [("emulate", 8, 9), ("witness", 9, 10)],
    [("emulate", 10, 11), ("witness", 11, 12), (INTERP, 12, 13),
     (COMMIT, 13, 17), ("proof end", 17, 17)],
]
# the port's log, in the order the spans ended
LOG = [("lookup.permute", None, -2.0, -1.0),  # before the window
       ("witness.fixed", None, 1.0, 2.0), ("witness.exe", None, 2.0, 3.0),
       ("ntt", INTERP, 3.0, 4.0), (INTERP, None, 3.0, 4.0),
       ("ntt", COMMIT, 4.5, 5.5), ("msm", COMMIT, 4.0, 7.0),
       (COMMIT, None, 4.0, 8.0),
       ("witness.fixed", None, 9.0, 9.5),  # the failed request's
       ("lookup.permute", COMMIT, 13.0, 14.0),
       ("lookup.multiplicity", COMMIT, 15.0, 16.0)]


def _run(profile=True):
    run = harness.Run({"k": 6}, None, 1.0)
    for i, sp in enumerate(REQUESTS):
        req = harness.Request(i, [])
        req.spans = list(sp)
        req.proof = b"proof" if sp[-1][0] == "proof end" else None
        run.requests.append(req)
    if profile:
        run.profile = Profile(OPS, 0.0, 20.0,
                              [s for sp in REQUESTS for s in sp])
    return run


@pytest.fixture
def log(monkeypatch):
    log = profiling.SpanLog(size=64)
    for name, phase, s, e in LOG:
        log.phase = phase
        log.record(name, s, e)
    log.phase = None
    monkeypatch.setattr(profiling, "spans", log.spans)
    monkeypatch.setattr(profiling, "dropped", lambda: log.lost)
    return log


def test_busy_is_the_union_clipped_to_each_span():
    p = Profile(OPS, 0.0, 20.0, [])
    busy = spans.Busy(p)
    assert busy.upto(0.0) == 0 and busy.upto(2.0) == pytest.approx(0.5)
    # [1.5, 2.5] ∪ [3.5, 4.5] ∪ [5, 6.5] = 3.5 over [0, 8]
    assert busy.between(0, 8) == pytest.approx(3.5)
    assert spans.seconds(p, [("x", 1.0, 3.0), ("y", None, 4.0, 8.0)]) == [
        (2.0, pytest.approx(1.0)), (4.0, pytest.approx(2.0))]
    assert busy.between(19.0, 25.0) == pytest.approx(0.5)  # k9 clipped


def test_the_phase_metrics_against_hand_counts(log):
    run = _run()
    assert spans.phase_seconds(run, "interpolate instance+advice") == 1.0
    assert spans.phase_seconds(run, "grand products") is None
    # A's commit [4, 8]: 0.5 of k3, 1.5 of k4 ∪ k5; C's [13, 17]: 1 of k8
    assert spans.phase_busy(run, "commit instance+advice") == \
        pytest.approx(1.5)
    assert spans.phase_busy(run, "quotient+commit") is None
    assert spans.phase_busy(_run(profile=False), "commit instance+advice") \
        is None


def test_port_spans_keep_the_completed_requests_alone(log):
    run = _run()
    kept = spans.port_spans(run)
    assert ("witness.fixed", None, 9.0, 9.5) not in kept  # the failed one
    assert ("lookup.permute", None, -2.0, -1.0) not in kept
    assert len(kept) == len(LOG) - 2
    # C's permute and multiplicity, 1 s each, over two requests
    assert spans.per_request_seconds(
        run, ("lookup.permute", "lookup.multiplicity")) == pytest.approx(1.0)


def test_a_log_that_dropped_entries_of_the_window_reads_none(log):
    assert spans.port_spans(_run()) is not None
    small = profiling.SpanLog(size=3)
    for name, phase, s, e in LOG:
        small.record(name, s, e)
    assert small.lost == len(LOG) - 3
    profiling.spans, profiling.dropped = small.spans, lambda: small.lost
    assert spans.port_spans(_run()) is None
    # it kept an entry that ended before the window: what it dropped
    # ended earlier still
    early = profiling.SpanLog(size=len(LOG))
    for name, phase, s, e in [("first", None, -4.0, -3.0)] + LOG:
        early.record(name, s, e)
    profiling.spans, profiling.dropped = early.spans, lambda: early.lost
    assert early.lost == 1 and spans.port_spans(_run()) is not None


def test_a_port_without_a_span_log_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    run = _run()
    assert spans.port_spans(run) is None and spans.breakdown(run) is None
    assert spans.phase_busy(run, "commit instance+advice") is not None


def test_idle_time_goes_to_the_innermost_leaf(log):
    out = spans.breakdown(_run())
    assert out["requests"] == 2
    # A idles 4.5 of its 8 s, C 5.5 of its 7 s
    assert out["idle_s"] == pytest.approx(5.0)
    want = {
        "emulate / -": 1.0,  # A [0, 1], C [10, 11]
        "witness / witness.fixed": 0.25,  # A [1, 2] less k1's 0.5
        "witness / witness.exe": 0.25,  # A [2, 3] less 0.5
        "witness / -": 0.5,  # C [11, 12]
        "interpolate instance+advice / ntt": 0.25,  # A [3, 4] less k3
        "interpolate instance+advice / -": 0.25,  # C [12, 13] less k7
        "commit instance+advice / ntt": 0.25,  # A [4.5, 5.5] less k4
        "commit instance+advice / msm": 0.25,  # A [4, 4.5], [5.5, 7]
        "commit instance+advice / -": 1.0,  # A [7, 8]; C [14, 15], [16, 17]
        "commit instance+advice / lookup.permute": 0.5,  # C [13, 14]
        "commit instance+advice / lookup.multiplicity": 0.5,  # C [15, 16]
    }
    assert out["idle"] == {k: pytest.approx(v) for k, v in want.items()}
    assert out["idle_in_leaves_s"] == pytest.approx(2.25)
    assert out["phases"][COMMIT] == {"wall_s": 4.0,
                                     "busy_s": pytest.approx(1.5)}
    # the leaves' own seconds include what is nested in them
    assert out["leaves"]["commit instance+advice / msm"] == {
        "wall_s": 1.5, "busy_s": pytest.approx(1.0)}


def test_the_readers_of_the_new_metrics(log):
    spec = Spec.load()
    run = _run()
    got = {name: spec.reader(name)(run) for name in (
        "interpolate_s", "grand_s", "permute_host_s", "commit_busy_s",
        "quotient_busy_s", "open_busy_s")}
    assert got == {"interpolate_s": 1.0, "grand_s": None,
                   "permute_host_s": pytest.approx(1.0),
                   "commit_busy_s": pytest.approx(1.5),
                   "quotient_busy_s": None, "open_busy_s": None}
