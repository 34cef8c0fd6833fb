"""BASELINE config 4 through the port at a small size on the CPU: the stages
of `prove_config(4)` and the record of `scripts/torch_prove_config4.py`
(the twin of scripts/prove_config4.py).

Config 4 is config 3's program at 2^20 steps and k = 21; here 2^8 steps
at W = 16 and k = 10, witness and mock (no proof: one CPU proof costs
minutes).  The record must hold each stage as it ends, and a stage that
raises (patched to raise) must be named as the one that stopped, with no
later stage run and exit code 1.
"""

import importlib.util
import json
import os

import pytest
import torch

from tinyram_tpu_torch.tinyram import prove_config as pc
from tinyram_tpu_torch.tinyram.bench_programs import config3_program

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--k", "10", "--word-bits", "16", "8"]
STAGES = ["emulate", "emulate native", "witness", "mock"]


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_prove_config4", os.path.join(ROOT, "scripts",
                                            "torch_prove_config4.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config4_is_config3_program_at_2_20_steps_k21():
    assert pc.CONFIGS[4] == (config3_program, 20, 21)


def test_prove_config4_runs_the_stages_on_cpu():
    heard = []
    report = pc.prove_config(4, 8, prove=False, device="cpu", word_bits=16,
                             k=10, log=lambda m: None,
                             on_stage=lambda *a: heard.append(a))
    assert [h[0] for h in heard] == STAGES
    assert all(h[2] is None and h[3] is None and h[4] is None for h in heard)
    assert [h[1] for h in heard] == [report["seconds"][s] for s in STAGES]
    assert report["config"] == 4 and report["k"] == 10
    assert report["steps"] == 249 and report["mock_failures"] == []
    assert report["objects"]["asg"].n == 1 << 10


def test_script_records_each_stage_as_it_ends(tmp_path, monkeypatch):
    mod = _script()
    out = tmp_path / "config4_report.json"
    snapshots = []
    on_stage = mod.Record.on_stage

    def spy(self, *args):
        on_stage(self, *args)
        snapshots.append(json.loads(out.read_text()))

    monkeypatch.setattr(mod.Record, "on_stage", spy)
    assert mod.main(["--mock", "--out", str(out), *SMALL]) == 0
    assert [list(s["stages"]) for s in snapshots] == [
        STAGES[:i + 1] for i in range(len(STAGES))]
    rec = json.loads(out.read_text())
    assert rec["stopped"] is None and rec["mock_failures"] == []
    assert rec["sizes"]["n"] == 1 << 10 and rec["sizes"]["steps"] == 249
    assert rec["sizes"]["advice"] > 0 and rec["sizes"]["lookups"] > 0
    assert rec["mem_total_gib"] > 0 and rec["peak_rss_gib"]["self"] > 0
    for s in rec["stages"].values():
        assert s["seconds"] >= 0 and s["peak_gib"] is None


@pytest.mark.parametrize("exc", [MemoryError, torch.cuda.OutOfMemoryError])
def test_script_names_the_stage_that_stopped(tmp_path, monkeypatch, exc):
    mod = _script()
    out = tmp_path / "config4_report.json"

    class Failing:
        def __init__(self, *a):
            raise exc("no room for the mock\nsecond line")

    monkeypatch.setattr(pc, "MockProver", Failing)
    assert mod.main(["--mock", "--prove", "--out", str(out), *SMALL]) == 1
    rec = json.loads(out.read_text())
    assert rec["stopped"]["stage"] == "mock"
    assert rec["stopped"]["error_type"] == exc.__name__
    assert rec["stopped"]["error"] == "no room for the mock"
    assert list(rec["stages"]) == STAGES[:3]  # nothing after the mock ran


def test_cpu_mock_not_attempted_without_the_memory(tmp_path, monkeypatch):
    mod = _script()
    out = tmp_path / "config4_report.json"
    monkeypatch.setattr(mod, "mem_total_bytes", lambda: 1 << 20)
    assert mod.main(["--mock", "--out", str(out), *SMALL]) == 0
    rec = json.loads(out.read_text())
    assert "MemTotal" in rec["not_attempted"]["mock"]
    assert list(rec["stages"]) == STAGES[:3] and rec["stopped"] is None


def test_instance_cache_dropped_after_a_config4_verify(monkeypatch):
    """`prove_config(4, frugal=True)`, as the config-4 script calls it,
    empties the verifier's instance-commitment cache after each
    verification (one entry would be ~12.5 GiB at k = 21) and records the
    held bytes (None off the card).  Setup, keygen, the proof and the
    verifier are stubbed: a CPU proof costs minutes; each stubbed verify
    fills the cache as the real one does.  The stubs record what config
    4's sizing (`SIZING[4]`) passes them: keygen's and the verifier's
    commit width and keygen's host store, the prover's widths; the
    witness rests in host memory."""
    from tinyram_tpu_torch.plonk import verifier
    from tinyram_tpu_torch.tinyram.circuit import TinyRamCircuit

    cleared = []
    clear = verifier.clear_instance_cache

    answers = []
    got = {"keygen": [], "prove": [], "verify": []}

    def verify(self, srs, pk, prog, answer, proof, **sizing):  # accepts the first
        answers.append(answer)
        got["verify"].append(sizing)
        verifier._INSTANCE_COMM_CACHE[answer] = ([torch.zeros(16, 4)], None)
        return len(answers) == 1

    def spy():
        cleared.append(dict(verifier._INSTANCE_COMM_CACHE))
        clear()

    monkeypatch.setattr(pc, "setup", lambda *a, **kw: "srs")
    def keygen(self, srs, **sizing):
        got["keygen"].append(sizing)
        return "pk"

    def create_proof(srs, pk, asg, rng, phase_hook, **sizing):
        got["prove"].append(sizing)
        return b"proof"

    monkeypatch.setattr(TinyRamCircuit, "keygen", keygen)
    monkeypatch.setattr(pc, "create_proof", create_proof)
    monkeypatch.setattr(TinyRamCircuit, "verify", verify)
    monkeypatch.setattr(verifier, "clear_instance_cache", spy)
    monkeypatch.setattr(verifier, "_INSTANCE_COMM_CACHE", {})
    report = pc.prove_config(4, 8, mock=False, device="cpu", word_bits=16,
                             k=10, cache_dir=None, log=lambda m: None,
                             frugal=True)
    assert report["proof_bytes"] == len(b"proof")
    assert answers[1] == answers[0] + 1
    sizing = pc.SIZING[4]
    assert got == {
        "keygen": [{"commit_chunk": sizing.commit_chunk, "host": True}],
        "prove": [sizing.prover()],
        "verify": [{"commit_chunk": sizing.commit_chunk}] * 2}
    assert sizing.prover() == {"ext_chunk": 2, "gate_slab": 8,
                               "commit_chunk": 2, "eval_slab": 8}
    assert report["objects"]["asg"].host
    assert [len(c) for c in cleared] == [1, 1]  # one entry, after each verify
    assert verifier._INSTANCE_COMM_CACHE == {}
    assert report["instance_cache_held"] == {
        name: {"before": None, "after": None}
        for name in ("verify", "verify answer+1")}
