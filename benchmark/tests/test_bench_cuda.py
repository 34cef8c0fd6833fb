"""On the card only (marked `cuda`; skipped without one): a whole run of
the `config2-prove` cell through the command, plain and traced, and the
profiler's marker that puts the device's intervals on the host's clock.

    python3 -m pytest benchmark/tests -m cuda -p no:cacheprovider
"""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.spec import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_of_config2_on_the_card(card, trace):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "config2-prove",
         "--seed", str(2**31 + 17 + trace), "--seconds", "2", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["breakdown"]["device_ops"]
        for name in ("msm_roofline_pct", "ntt_roofline_pct"):
            assert 0 < out["metrics"][name]["value"] <= 100
    else:
        assert set(out["metrics"]) == {"setup_s", "proof_s", "peak_gib"}


def test_the_marker_aligns_device_and_host_clocks(card):
    from benchmark.trace import Profile, Recorder

    rec = Recorder()
    rec.start()
    t0 = time.perf_counter()
    time.sleep(0.2)
    t1 = time.perf_counter()
    x = torch.ones(1 << 20, device="cuda")
    (x * 2).sum().item()
    ops = rec.stop()
    assert ops
    p = Profile(ops, t0, time.perf_counter(), [("late", t1, time.perf_counter())])
    first = min(s for _, s, _ in p.ops)
    assert first >= t1 - 0.01  # nothing ran on the card while the host slept
    assert p.idle_gaps(1)[0][1] >= 0.15
