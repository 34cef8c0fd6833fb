"""On the card only (marked `cuda`; each test skips without one): BASELINE
config 3 at its 32-bit word (W = 32, k = 18), the cell `config3w32-prove`:

  * a run of the benchmark's command comes out `correct`: the reference
    re-emulates every request and verifies the proofs;
  * the control (`benchmark/control.py`: the witness claims answer + 1)
    comes out incorrect on each of three seeds;
  * a traced window gives a value to every per-layer metric that lists
    the cell, each share of a roofline within 100 %, and the harness's
    spans tile each request.

The machine with the card has no JAX:

    python3 -m pytest --noconftest -m cuda tests/test_torch_w32_cuda.py

(~15 min: three set-ups at k = 18 and four checked windows.)
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

pytestmark = pytest.mark.cuda

CELL = "config3w32-prove"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")


def _lines(proc) -> list[dict]:
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def test_a_w32_run_of_the_command_is_correct(card):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         str(2**31 + 1901), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    out = _lines(proc)[-1]
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["proofs_checked"]["value"] >= 1
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert set(out["metrics"]) == {"setup_s", "proof_s", "peak_gib"}


def test_the_w32_control_is_incorrect_on_every_seed(card):
    seeds = [2**31 + 1911, 2**32 + 1913, 3190001917]
    proc = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", CELL,
         "--seeds", ",".join(map(str, seeds)), "--seconds", "51"],
        cwd=ROOT, capture_output=True, text=True, timeout=2400)
    runs = [line for line in _lines(proc) if "seed" in line]
    assert [r["seed"] for r in runs] == seeds
    for r in runs:
        assert r["correct"] is False, r
        caught = r["checks"]["proofs_rejected"]["value"] + \
            r["checks"]["requests_failed"]["value"]
        assert caught >= 1, r


def test_a_traced_w32_window_reports_every_per_layer_metric(card):
    from benchmark import harness, programs
    from benchmark.reference.tinyram_cs import TinyRamCS
    from benchmark.spec import Spec
    from benchmark.trace import Recorder

    seed = 2**31 + 1921
    spec = Spec.load()
    cell = harness.Cell(spec, CELL)
    cell.warm_up(seed)
    config = cell.config
    run = harness.Run(config, TinyRamCS(config["word_bits"],
                                        config["reg_count"],
                                        k=config["k"]).cs, 1.0)
    harness.window(cell.system, programs.Client(cell.config, cell.traffic,
                                                seed), run, Recorder())
    done = run.completed
    assert done and len(done) == len(run.requests)
    listed = spec.metrics(CELL, trace=True)
    assert len(listed) == len(spec.benchmark["per_layer"])
    values = {m["name"]: spec.reader(m["name"])(run) for m in listed}
    assert [name for name, v in values.items() if v is None] == []
    assert values["device_busy_s"] > 0 and values["launches_per_proof"] > 0
    for name in ("msm_roofline_pct", "ntt_roofline_pct"):
        assert 0 < values[name] <= 100, (name, values[name])
    for req in done:
        tiled = sum(e - s for _, s, e in req.spans)
        assert abs(tiled - req.seconds) <= 1e-3 * req.seconds
