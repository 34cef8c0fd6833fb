"""The harness: a whole run of a W = 8 cell on the CPU (the look for a card
skipped), with the timed path sound and with each fault it can have
planted underneath; the result line, the import guard, discovery by
name, the trace's arithmetic and BENCHMARK.json's own limits."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.faults import FAULTS
from benchmark.spec import HERE, ROOT, Spec
from benchmark.tests.support import CELL, w8_spec
from benchmark.trace import Profile, short_name

torch.set_num_threads(1)

SEED = 2**31 + 4242


def _run(tmp_path, fault=None, seed=SEED):
    return harness.execute(w8_spec(str(tmp_path)), CELL, seed, 0.001, False,
                           time.time(), device="cpu", pool=1, fault=fault)


def test_a_sound_run(tmp_path):
    out = _run(tmp_path)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "proof_s"}  # no card: no peak
    assert all(m["value"] > 0 and m["unit"] == "s"
               for m in out["metrics"].values())
    assert out["device"]["count"] == 1
    assert out["checks"]["proofs_checked"]["value"] == 1
    json.dumps(out)


@pytest.mark.parametrize("fault,fails", [
    ("stale", "proofs_rejected"), ("answer", "traces_differing"),
    ("half", "requests_failed"), ("byte", "proofs_rejected"),
    ("control", "proofs_rejected")])
def test_a_fault_underneath_makes_the_run_incorrect(tmp_path, fault, fails):
    out = _run(tmp_path, FAULTS[fault])
    assert out["correct"] is False
    assert out["checks"][fails]["value"] > out["checks"][fails]["limit"]


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    assert "tinyram_tpu_torch" not in harness.FORBIDDEN
    import types

    for name in ("tinyram_tpu_torch", "tinyram_tpu_torch.x", "jaxon", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "tinyram_tpu", types.ModuleType("tinyram_tpu"))
    assert harness.loaded_forbidden() == ["jax.numpy", "tinyram_tpu"]


def test_files_added_by_name_are_found(tmp_path):
    for sub in ("configs", "traffic", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "newcfg.json").write_text('{"k": 9}')
    (tmp_path / "traffic" / "newmix.json").write_text('{"steps_log2": [12]}')
    (tmp_path / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench = {"workloads": [{"name": "a", "config": "newcfg", "traffic": "newmix",
                            "chips": 1, "why": "x"}],
             "end_to_end": [{"name": "setup_s"}],
             "per_layer": [{"name": "new_metric", "workloads": ["a"]},
                           {"name": "other", "workloads": ["b"]}]}
    spec = Spec(bench, str(tmp_path / "configs"), str(tmp_path / "traffic"),
                str(tmp_path / "metrics"))
    assert spec.config("newcfg") == {"k": 9}
    assert spec.traffic("newmix") == {"steps_log2": [12]}
    assert spec.reader("new_metric")(None) == 42.0
    assert [m["name"] for m in spec.metrics("a", trace=True)] == ["new_metric"]
    assert [m["name"] for m in spec.metrics("a", trace=False)] == ["setup_s"]


def test_every_metric_of_the_benchmark_has_a_reader():
    spec = Spec.load()
    for m in spec.benchmark["end_to_end"] + spec.benchmark["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in spec.benchmark["workloads"]:
        assert spec.config(w["config"])["name"] == w["config"]
        assert spec.traffic(w["traffic"])


def test_without_a_card_or_the_port_a_run_prints_no_result(tmp_path):
    cmd = [sys.executable, "benchmark/run.py", "--workload", "config2-prove",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    bare = tmp_path / "checkout"
    bare.mkdir()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    shutil.copytree(HERE, bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(cmd, cwd=bare, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_profile_arithmetic():
    ops = [("void ntt_rows_kernel<16>(unsigned int const*)", 1.0, 2.0),
           ("padd_kernel", 1.5, 2.5), ("madd_scan_kernel", 4.0, 5.0),
           ("late", 9.5, 11.0)]
    spans = [("witness", 0.0, 1.2), ("prover.commit instance+advice", 1.2, 6.0)]
    p = Profile(ops, 0.0, 10.0, spans)
    assert p.busy == [(1.0, 2.5), (4.0, 5.0), (9.5, 10.0)]
    assert p.busy_s == pytest.approx(3.0)
    assert p.seconds_of(("padd_kernel", "madd_scan_kernel")) == pytest.approx(2.0)
    assert p.idle_gaps(2) == [["between requests", pytest.approx(4.5)],
                              ["prover.commit instance+advice", pytest.approx(1.5)]]
    assert p.idle_gaps()[-1] == ["witness", pytest.approx(1.0)]
    assert p.top_ops(1) == [["ntt_rows_kernel", pytest.approx(1.0)]]
    assert short_name("void a::b<c<d>>(int)") == "a::b"


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contracts_limits():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in b["workloads"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and "\t" not in m["layer"] and len(m["layer"]) <= 200
    for x in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]:
        assert NAME.match(x["name"]) and x["name"] not in names
        names.add(x["name"])
        if "unit" in x:
            assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for path, _, files in os.walk(HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(path, f), ROOT)
            if "__pycache__" not in rel:
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    assert math.isfinite(len(json.dumps(b))) and len(json.dumps(b)) < 64 * 1024
