"""Port NTT / domain (tinyram_tpu_torch.poly) against the JAX package.

Same seeded inputs through `tinyram_tpu.poly` and the port; outputs equal
limb for limb (tolerance 0).  The four-step composition of kernel B2 runs
here with B2's plain version as its base (a CPU tensor), at small base
sizes so that the recursion is exercised.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinyram_tpu.field import FP as JFP
from tinyram_tpu.poly.domain import Domain as JDomain
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.poly import cuda_ntt
from tinyram_tpu_torch.poly.domain import Domain

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

# the packages' __init__ re-export the function `ntt` over the module name
jntt = importlib.import_module("tinyram_tpu.poly.ntt")
tntt = importlib.import_module("tinyram_tpu_torch.poly.ntt")


def _rand(shape, seed):
    """Canonical Fp limbs (< 2^254) as a uint32 numpy array."""
    limbs = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(16,) + tuple(shape), dtype=np.int64)
    limbs[15] &= 0x3FFF
    return limbs.astype(np.uint32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


def _t(a):
    return torch.as_tensor(a.astype(np.int32))


@pytest.mark.parametrize("log_n", [1, 2, 4, 8, 10, 12])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax(log_n, inverse):
    a = _rand((3, 1 << log_n) if log_n <= 10 else (1 << log_n,), seed=log_n)
    want = _np(jntt.ntt(JFP, jnp.asarray(a), inverse))
    np.testing.assert_array_equal(_np(tntt.ntt(FP, _t(a), inverse)), want)


@pytest.mark.parametrize("log_n,log_s_max", [(6, 2), (9, 3), (12, 10)])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_with_plain_base_matches_jax(log_n, log_s_max, inverse):
    a = _rand((2, 1 << log_n), seed=100 + log_n)
    want = _np(jntt.ntt(JFP, jnp.asarray(a), inverse))
    got = cuda_ntt.ntt_cuda(FP, _t(a), inverse, log_s_max=log_s_max)
    np.testing.assert_array_equal(_np(got), want)


def test_b2_plain_multipliers():
    """B2's plain version: rows transformed, times mult[r % M], times scale."""
    x = _t(_rand((6, 16), seed=7))
    mult = _t(_rand((3, 16), seed=8))
    scale = _t(_rand((), seed=9))
    got = cuda_ntt.colntt(x, FP, False, mult, scale)  # CPU: plain version
    y = tntt.ntt(FP, x)
    want = FP.mul(FP.mul(y.reshape(16, 2, 3, 16), mult[:, None]),
                  scale.reshape(16, 1, 1, 1)).reshape(16, 6, 16)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        cuda_ntt.colntt(_t(_rand((2, 2048), seed=1)), FP, False)


def test_domain_matches_jax():
    k, ext = 6, 8
    jd, td = JDomain(JFP, k, ext), Domain(FP, k, ext, "cpu")
    a = _rand((2, 1 << k), seed=11)
    coeff_j = jd.lagrange_to_coeff(jnp.asarray(a))
    coeff_t = td.lagrange_to_coeff(_t(a))
    np.testing.assert_array_equal(_np(coeff_t), _np(coeff_j))
    ext_j = jd.coeff_to_extended(coeff_j)
    ext_t = td.coeff_to_extended(coeff_t)
    np.testing.assert_array_equal(_np(ext_t), _np(ext_j))
    np.testing.assert_array_equal(_np(td.extended_to_coeff(ext_t)),
                                  _np(jd.extended_to_coeff(ext_j)))
    np.testing.assert_array_equal(_np(td.divide_by_vanishing(ext_t)),
                                  _np(jd.divide_by_vanishing(ext_j)))
    np.testing.assert_array_equal(td.l0_evals_ext().astype(np.int64),
                                  _np(jd.l0_evals_ext()))
    np.testing.assert_array_equal(_np(td.lagrange_sum_ext((3, 60))),
                                  _np(jd.lagrange_sum_ext((3, 60))))
    assert td.lagrange_evals_host(12345, [0, 5]) == \
        jd.lagrange_evals_host(12345, [0, 5])


def test_eval_poly_tree_sum_coeff_scale_match_jax():
    a = _rand((3, 37), seed=12)
    x = _rand((), seed=13)
    np.testing.assert_array_equal(
        _np(tntt.eval_poly(FP, _t(a), _t(x))),
        _np(jntt.eval_poly(JFP, jnp.asarray(a), jnp.asarray(x))))
    np.testing.assert_array_equal(
        _np(tntt.tree_sum(FP, _t(a), axis=1)),
        _np(jntt.tree_sum(JFP, jnp.asarray(a), 1)))
    np.testing.assert_array_equal(
        _np(tntt.coeff_scale(FP, _t(a), 5)),
        _np(jntt.coeff_scale(JFP, jnp.asarray(a), 5)))
    np.testing.assert_array_equal(tntt.powers(FP, 7, 20).astype(np.int64),
                                  _np(jntt.powers(JFP, 7, 20)))
