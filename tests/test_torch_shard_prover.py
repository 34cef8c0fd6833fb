"""The k = 6 toy circuit proved on a mesh of two gloo ranks of the CPU.

`entry.dryrun_multichip(2, device="cpu", seed=...)`: the sharded NTT, MSM
and row-sharded gate of the dry run, then `create_proof(mesh=)` on both
ranks under the seeded stream of tests/data/torch_golden_toy6.npz (made
by scripts/torch_golden_toy.py from the JAX package).  Rank 0 draws and
broadcasts the blinds, so both ranks return the JAX package's bytes; the
port's single-device verifier accepts the proof and rejects it against a
changed public input.  Tolerance 0.  Every coefficient column stays as
the rank's row block: per phase, each rank gathers only what
`shard.paths.gather_pattern` reckons.  The ranks run under the dry run's
deadline.
"""

import os

import numpy as np
import pytest
import torch

from tinyram_tpu_torch.entry import dryrun_multichip
from tinyram_tpu_torch.plonk.toy import K, toy_circuit
from tinyram_tpu_torch.shard import paths

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_toy6.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def run(golden):
    lines = []
    res = dryrun_multichip(2, device="cpu", seed=int(golden["seed"]),
                           timeout_s=900, log=lines.append)
    return res, lines


def test_dryrun_reports_every_path(run):
    res, lines = run
    assert lines[-1] == res["summary"] == (
        "dryrun_multichip(2): NTT + MSM + row-sharded gate eval + sharded "
        "create_proof->verify OK")
    assert "2 ranks on cpu, backend gloo" in lines[0]
    assert [sorted(s) for s in res["stats"]] == [["msm", "ntt", "proof"]] * 2


def test_both_ranks_return_the_jax_bytes(run, golden):
    res, _ = run
    assert res["proofs"] == [golden["proof"].tobytes()] * 2


def test_single_device_verifier_accepts(run):
    assert run[0]["verified"] is True


def test_rejected_against_a_changed_public_input(run):
    assert run[0]["rejected"] is True


def test_phase_collectives_hold_the_row_block_pattern(run):
    """Per prover phase and rank, the all-gathers are exactly what
    `paths.gather_pattern` reckons from the toy's constraint system: the
    commitments' MSM partials and nothing of the coefficient stacks in the
    first three phases, nothing in the fold, one sum a slot in the
    evaluations, and one gather of the opened polynomial in the multiopen.
    No transform goes unsplit, and the whole proof gathers no more than the
    phases do (the instance and advice transforms, a phase of their own,
    gather nothing)."""
    res, _ = run
    toy = toy_circuit()
    want = paths.gather_pattern(toy.cs, K, 2)
    assert want["commit instance+advice"] == 3 * 4
    for st in (s["proof"] for s in res["stats"]):
        assert set(st["phases"]) == set(want)
        assert paths.gathered_by_phase(st) == want
        assert not any("unsplit" in c for c in st["phase_collectives"].values())
        assert st["collectives"]["all_gather"] == sum(want.values())
        assert set(st["phase_peak_gib"]) == set(want)
