"""The port's proofs of the toy circuits of tests/test_plonk.py (K = 3) and
tests/test_range_lookup.py (K = 6) against the JAX package's.

The circuits are copied into `tinyram_tpu_torch/plonk/toy.py`.  The JAX
side is the fixture tests/data/torch_golden_toys.npz, recorded by
scripts/torch_golden_toys.py from the seven JAX proof tests under a seeded
`secrets.randbelow` stream (seed per test in `toy.TOY_TESTS`).

- Not slow: the port's keygen gives the recorded fixed and permutation
  commitments; the port verifier accepts every recorded JAX proof and
  gives each tampered one (wrong public input, a flipped byte, the
  witness with a broken mul gate, the forged multiplicity commitment) the
  verdict the JAX verifier gave, which is what the JAX test asserts.
- Slow, as the JAX originals are (one CPU proof costs minutes): the port's
  own proof under the same stream equals the recorded bytes, its outcomes
  equal the JAX ones, and the out-of-range witness is refused with the
  JAX prover's ValueError text.

Tolerance 0: commitments and proof bytes equal.
"""

import os

import numpy as np
import pytest
import torch

from tinyram_tpu_torch.convert import points_from_bytes
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.plonk import verify_proof
from tinyram_tpu_torch.plonk import toy
from tinyram_tpu_torch.shard.paths import SeededRng

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_toys.npz")
PROOF_TESTS = [t for t in toy.TOY_TESTS if t != "range_out_of_range"]
# what each JAX test asserts of its outcomes
EXPECTED = {
    "plonk_roundtrip": {"verify": True},
    "plonk_soundness": {"verify": True, "wrong_public": False,
                        "flipped_byte": False},
    "plonk_bad_witness": {"verify": False},
    "range_roundtrip": {"verify": True, "flipped_byte": False},
    "range_forged_m": {"verify": True, "forged_m": False},
    "mixed": {"verify": True, "mock_clean": True, "mock_names_sq": True},
}


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def keys():
    """circuit -> (toy, srs, pk), each made once, when first asked for."""
    made, srs = {}, {}

    def get(circuit):
        if circuit not in made:
            k = toy.TOY_CIRCUITS[circuit][1]
            if k not in srs:
                srs[k] = setup(k, device="cpu")
            t, pk = toy.toy_keys(circuit, srs[k], "cpu")
            made[circuit] = (t, srs[k], pk)
        return made[circuit]
    return get


def _outcomes(golden, test):
    prefix = f"{test}/outcome/"
    return {k[len(prefix):]: bool(v) for k, v in golden.items()
            if k.startswith(prefix)}


def _public(golden, test):
    return [[int.from_bytes(row.tobytes(), "little") for row in col]
            for col in golden[f"{test}/public"]]


@pytest.mark.parametrize("circuit", list(toy.TOY_CIRCUITS))
def test_keygen_matches_recorded_vk(golden, keys, circuit):
    _, _, pk = keys(circuit)
    assert int(golden[f"{circuit}/k"]) == toy.TOY_CIRCUITS[circuit][1]
    assert pk.vk.fixed_commitments == points_from_bytes(
        golden[f"{circuit}/fixed_comm"], golden[f"{circuit}/fixed_comm_none"])
    assert pk.vk.sigma_commitments == points_from_bytes(
        golden[f"{circuit}/sigma_comm"], golden[f"{circuit}/sigma_comm_none"])


@pytest.mark.parametrize("test", PROOF_TESTS)
def test_port_verifier_on_jax_proofs(golden, keys, test):
    """Cross-verification: the JAX proof and its tampered forms, judged by
    the port verifier, get the JAX verdicts (those the JAX test asserts)."""
    circuit = toy.TOY_TESTS[test][0]
    t, srs, pk = keys(circuit)
    _, instances = toy.toy_witness(test, t, "cpu")
    assert _public(golden, test) == instances
    want = _outcomes(golden, test)
    got = toy.toy_outcomes(
        test, lambda inst, p: verify_proof(srs, pk.vk, inst, p), instances,
        golden[f"{test}/proof"].tobytes())
    if test == "mixed":  # the test's mock verdicts, no proof needed
        got.update(toy.mixed_mock_outcomes(t, "cpu"))
    assert got == want == EXPECTED[test]


@pytest.mark.slow
@pytest.mark.parametrize("test", list(toy.TOY_TESTS))
def test_port_proof_equals_jax_bytes(golden, keys, test):
    t, srs, pk = keys(toy.TOY_TESTS[test][0])
    seed = int(golden[f"{test}/seed"])
    assert seed == toy.TOY_TESTS[test][1]
    got = toy.prove_toy(test, srs, pk, t, SeededRng(seed), "cpu")
    if test == "range_out_of_range":
        assert got["proof"] is None
        assert got["error"] == str(golden[f"{test}/error"])
        assert "not in table" in got["error"]
        return
    assert got["proof"] == golden[f"{test}/proof"].tobytes()
    assert got["outcomes"] == _outcomes(golden, test) == EXPECTED[test]
