"""On the card only (marked `cuda`; skipped without one): a traced run of
`config2-prove` through the command prints the six metrics that read the
port's spans, and the `Recorder`'s CUDA-only profiler session turns the
port's span recorder on.

    python3 -m pytest benchmark/tests/test_bench_spans_cuda.py -m cuda -p no:cacheprovider
"""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.spec import ROOT

pytestmark = pytest.mark.cuda

NEW = ("interpolate_s", "grand_s", "permute_host_s", "commit_busy_s",
       "quotient_busy_s", "open_busy_s")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def test_the_recorder_is_on_under_the_cuda_only_session(card):
    """In a process of its own: a second profiler session in this one
    would read no device operations (`test_bench_cuda.py`'s marker)."""
    code = (
        "import torch\n"
        "from benchmark.trace import Recorder\n"
        "from tinyram_tpu_torch.utils import profiling\n"
        "assert not profiling.log.on()\n"
        "rec = Recorder()\n"
        "rec.start()\n"
        "with profiling.span('probe'):\n"
        "    torch.ones(1 << 10, device='cuda').sum().item()\n"
        "ops = rec.stop()\n"
        "assert ops and not profiling.log.on()\n"
        "print([e[0] for e in profiling.spans()])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1] == "['probe']"


def test_a_traced_run_prints_the_span_metrics(card):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "config2-prove",
         "--seed", str(2**31 + 161), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(m)
    assert m["interpolate_s"] > 0 and m["grand_s"] > 0
    assert 0 < m["permute_host_s"] < m["lookup_s"]
    assert 0 < m["commit_busy_s"] <= m["commit_s"]
    assert 0 < m["quotient_busy_s"] <= m["quotient_s"]
    assert 0 < m["open_busy_s"] <= m["open_s"]
