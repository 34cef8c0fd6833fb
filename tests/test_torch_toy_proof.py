"""The port's single-device proof of the k = 6 toy circuit against JAX bytes.

The circuit and witness of `__graft_entry__.dryrun_multichip` and
tests/test_shard_prover.py (`tinyram_tpu_torch/plonk/toy.py` in the port).
A live JAX proof takes minutes on a CPU (XLA compiles), so the JAX side is
the fixture tests/data/torch_golden_toy6.npz, made by
scripts/torch_golden_toy.py from the JAX package under a seeded
`secrets.randbelow` stream; the port's `create_proof(rng=...)` draws the
same values in the same order.  Tolerance 0: commitments and proof bytes
must be equal.  The sharded proof of the same circuit is in
test_torch_shard_prover.py (one proof per file, so that the test workers
run them side by side).
"""

import os

import numpy as np
import pytest
import torch

from tinyram_tpu_torch.convert import points_from_bytes
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.plonk import create_proof, keygen
from tinyram_tpu_torch.plonk.toy import K, toy_circuit
from tinyram_tpu_torch.shard.paths import SeededRng

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_toy6.npz")


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def keys():
    toy = toy_circuit()
    srs = setup(K, device="cpu")
    return toy, srs, keygen(srs, toy.cs, toy.fixed_assignment("cpu"))


def test_keygen_matches_recorded_vk(golden, keys):
    toy, _, pk = keys
    assert int(golden["k"]) == K
    assert pk.vk.fixed_commitments == points_from_bytes(
        golden["fixed_comm"], golden["fixed_comm_none"])
    assert pk.vk.sigma_commitments == points_from_bytes(
        golden["sigma_comm"], golden["sigma_comm_none"])
    public = [int.from_bytes(row.tobytes(), "little") for row in golden["public"]]
    assert public == toy.public_values(toy.witness_values())


def test_single_device_proof_equals_jax_bytes(golden, keys):
    toy, srs, pk = keys
    proof = create_proof(srs, pk, toy.assignment(device="cpu"),
                         rng=SeededRng(int(golden["seed"])))
    assert proof == golden["proof"].tobytes()
