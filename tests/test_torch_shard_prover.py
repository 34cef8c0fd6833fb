"""The k = 6 toy circuit proved on a mesh of two gloo ranks of the CPU.

`entry.dryrun_multichip(2, device="cpu", seed=...)`: the sharded NTT, MSM
and row-sharded gate of the dry run, then `create_proof(mesh=)` on both
ranks under the seeded stream of tests/data/torch_golden_toy6.npz (made
by scripts/torch_golden_toy.py from the JAX package).  Rank 0 draws and
broadcasts the blinds, so both ranks return the JAX package's bytes; the
port's single-device verifier accepts the proof and rejects it against a
changed public input.  Tolerance 0.  The ranks run under the dry run's
deadline.
"""

import os

import numpy as np
import pytest
import torch

from tinyram_tpu_torch.entry import dryrun_multichip

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
