"""The port's span recorder (`utils/profiling.py`) on the k = 6 toy proof
of test_torch_toy_proof.py: off, a proof records nothing; inside
`recording()` it records the eight prover phases in order, tiling the
proof, each leaf span inside its phase, and the proof bytes stay the
recorded JAX ones.  A CPU `torch.profiler` session records too, and the
log drops what passes its bound and counts it.  The TinyRAM proof's
lookup and witness spans are checked in test_torch_proof_answer.py."""

import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.plonk import create_proof, keygen
from tinyram_tpu_torch.plonk.prover import PHASES
from tinyram_tpu_torch.plonk.toy import K, toy_circuit
from tinyram_tpu_torch.shard.paths import SeededRng
from tinyram_tpu_torch.utils import profiling

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_toy6.npz")
GAP = 1e-3  # seconds between one phase's end and the next one's start


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def keys():
    toy = toy_circuit()
    srs = setup(K, device="cpu")
    return toy, srs, keygen(srs, toy.cs, toy.fixed_assignment("cpu"))


def _prove(golden, keys, asg=None):
    toy, srs, pk = keys
    asg = toy.assignment(device="cpu") if asg is None else asg
    return create_proof(srs, pk, asg,
                        rng=SeededRng(int(golden["seed"])))


@pytest.fixture(scope="module")
def recorded(golden, keys):
    """One proof inside `recording()`: (proof, the start and end of its
    `create_proof` call, the entries it logged)."""
    profiling.log.clear()
    asg = keys[0].assignment(device="cpu")
    with profiling.recording():
        t0 = time.perf_counter()
        proof = _prove(golden, keys, asg)
        t1 = time.perf_counter()
    return proof, t0, t1, profiling.spans(t0, t1)


def test_a_proof_records_nothing_with_the_recorder_off(golden, keys):
    profiling.log.clear()
    assert not profiling.log.on()
    assert _prove(golden, keys) == golden["proof"].tobytes()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_a_recorded_proof_equals_the_jax_bytes(golden, recorded):
    proof, _, _, entries = recorded
    assert proof == golden["proof"].tobytes()
    assert entries and profiling.dropped() == 0


def test_the_eight_phases_tile_the_proof_in_order(recorded):
    _, t0, t1, entries = recorded
    phases = [e for e in entries if e[0].startswith("prover.")]
    assert [e[0] for e in phases] == [f"prover.{p}" for p in PHASES]
    assert all(e[1] is None for e in phases)
    assert 0 <= phases[0][2] - t0 < GAP and 0 <= t1 - phases[-1][3] < GAP
    for a, b in zip(phases, phases[1:]):
        assert 0 <= b[2] - a[3] < GAP, (a, b)


def test_every_leaf_lies_inside_its_phase(recorded):
    _, _, _, entries = recorded
    phases = {e[0]: e for e in entries if e[0].startswith("prover.")}
    leaves = [e for e in entries if not e[0].startswith("prover.")]
    assert {e[0] for e in leaves} >= {"ntt", "msm", "lookup.compress",
                                      "lookup.fetch", "lookup.permute",
                                      "lookup.upload", "grand.products",
                                      "quotient.eval", "open.evaluate",
                                      "open.fold", "ipa.round", "ipa.decode",
                                      "ipa.lincomb", "ipa.powers"}
    for name, phase, s, e in leaves:
        ph = phases[phase]
        assert ph[2] <= s <= e <= ph[3], (name, phase)
    rounds = [e for e in leaves if e[0] == "ipa.round"]
    assert len(rounds) == K


def test_a_cpu_profiler_session_records_without_recording():
    assert not profiling.log.on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.log.on()
        t0 = time.perf_counter()
        with profiling.span("probe"):
            pass
        t1 = time.perf_counter()
    assert [e[0] for e in profiling.spans(t0, t1)] == ["probe"]
    with profiling.span("after"):
        pass
    assert "after" not in [e[0] for e in profiling.spans()]


def test_the_log_drops_past_its_bound_and_counts():
    log = profiling.SpanLog(size=4)
    with log.recording():
        for i in range(10):
            with log.span(f"s{i}"):
                pass
    assert log.lost == 6
    assert [e[0] for e in log.spans()] == ["s6", "s7", "s8", "s9"]
    with log.span("off"):
        pass
    assert log.lost == 6 and len(log.spans()) == 4
