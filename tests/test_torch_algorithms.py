"""The algorithm switches of `create_proof` (`ntt_method=`, `msm_affine=`)
and the context that carries them (`tinyram_tpu_torch/utils/algorithms.py`)
to the domain transforms and the IPA's MSMs, where the JAX package reads
`TINYRAM_NTT` and `TINYRAM_MSM_AFFINE`.

On the CPU both switches select the same plain code (the CPU transform is
radix-2 whatever the method, and the toy circuit's MSMs take the bit-serial
path), so the proof bytes must stay the recorded JAX bytes; the routing
itself is checked by recording what the domain and the IPA pass on.
"""

import numpy as np
import pytest
import torch

from tinyram_tpu_torch.curve.vesta import identity
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.ipa import ipa
from tinyram_tpu_torch.plonk import create_proof
from tinyram_tpu_torch.poly import domain as dom_mod
from tinyram_tpu_torch.poly.domain import Domain
from tinyram_tpu_torch.utils import algorithms
from tinyram_tpu_torch.utils.algorithms import msm_affine, ntt_method

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them


def test_context_defaults_nesting_and_validation():
    assert (ntt_method(), msm_affine()) == ("b2", False)
    with algorithms.algorithms("mxu", True):
        assert (ntt_method(), msm_affine()) == ("mxu", True)
        with algorithms.algorithms():
            assert (ntt_method(), msm_affine()) == ("b2", False)
        assert (ntt_method(), msm_affine()) == ("mxu", True)
    assert (ntt_method(), msm_affine()) == ("b2", False)
    with pytest.raises(ValueError):
        with algorithms.algorithms("pallas"):
            pass
    assert (ntt_method(), msm_affine()) == ("b2", False)


def test_domain_and_ipa_pass_the_context_on(monkeypatch):
    seen = []
    monkeypatch.setattr(dom_mod, "ntt", lambda f, a, inverse=False, method=None:
                        seen.append(("ntt", method)) or a)
    monkeypatch.setattr(ipa, "msm_many", lambda s, p, affine=False:
                        seen.append(("msm", affine)) or identity((1,)))
    d = Domain(FP, 3, 4, device="cpu")
    a = FP.zeros((8,))
    sc = FP.zeros((1, 8))
    d.coeff_to_lagrange(a)
    ipa._msm_dispatch(sc, identity((8,)))
    with algorithms.algorithms("mxu", True):
        d.coeff_to_lagrange(a)
        ipa._msm_dispatch(sc, identity((8,)))
    assert seen == [("ntt", "b2"), ("msm", False), ("ntt", "mxu"),
                    ("msm", True)]


def test_create_proof_rejects_an_unknown_method():
    with pytest.raises(ValueError):
        create_proof(None, None, None, ntt_method="radix4")


def test_toy_proof_with_both_switches_equals_jax_bytes():
    import os

    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.plonk import keygen
    from tinyram_tpu_torch.plonk.toy import K, toy_circuit
    from tinyram_tpu_torch.shard.paths import SeededRng

    golden = dict(np.load(os.path.join(os.path.dirname(__file__), "data",
                                       "torch_golden_toy6.npz")))
    toy = toy_circuit()
    srs = setup(K, device="cpu")
    pk = keygen(srs, toy.cs, toy.fixed_assignment("cpu"))
    proof = create_proof(srs, pk, toy.assignment(device="cpu"),
                         rng=SeededRng(int(golden["seed"])),
                         ntt_method="mxu", msm_affine=True)
    assert proof == golden["proof"].tobytes()
