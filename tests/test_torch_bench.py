"""`python -m tinyram_tpu_torch.bench` on the CPU at tiny sizes (the MSMs on
the bit-serial path, NTTs of 2^8, modmul at 2^10, no prove steps): one
JSON line under 1,500 characters with every metric's median, min and max;
and a step that raises is recorded by name and makes the exit code 1."""

import json
import os
import subprocess
import sys

import torch

from tinyram_tpu_torch import bench

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--log-msm", "2", "--log-msm2", "3",
        "--log-modmul", "10", "--log-ntt", "8", "--log-ntt-b", "8",
        "--ntt-cols", "2", "--iters", "1", "--no-prove"]
METRICS = {"msm_points_per_s": "n", "msm2_points_per_s": "n",
           "modmul_per_s": "n", "ntt_elems_per_s": "n",
           "ntt_batched_elems_per_s": "shape"}


def test_bench_prints_one_line_with_every_metric():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "tinyram_tpu_torch.bench", *TINY],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1 and len(lines[0]) < 1500
    rec = json.loads(lines[0])
    assert rec["device"] == "cpu" and rec["iters"] == 1 and rec["errors"] == {}
    for name, size in METRICS.items():
        m = rec[name]
        assert m["min"] <= m["med"] <= m["max"] and m["min"] > 0, name
        assert size in m, name
    assert rec["ntt_batched_elems_per_s"]["shape"] == "2x2^8"
    assert rec["msm2_points_per_s"]["n"] == "2^3"


def test_a_step_that_raises_exits_1(monkeypatch, tmp_path, capsys):
    def broken(self, log_n):
        raise RuntimeError("no NTT today")

    monkeypatch.setattr(bench, "PARTIAL", str(tmp_path / "partial.json"))
    monkeypatch.setattr(bench.Bench, "msm", lambda self, name, log_n: None)
    monkeypatch.setattr(bench.Bench, "ntt", broken)
    assert bench.main(TINY) == 1
    rec = json.loads(capsys.readouterr().out)
    assert rec["errors"] == {"ntt_elems_per_s": "RuntimeError: no NTT today"}
    assert {"modmul_per_s", "ntt_batched_elems_per_s"} <= set(rec)
    assert "ntt_elems_per_s" not in rec
    partial = json.loads((tmp_path / "partial.json").read_text())
    assert partial["errors"] == rec["errors"]
