"""The digit-matmul NTT (`tinyram_tpu_torch/poly/mxu_ntt.py`, kernel M1's
plain version on the CPU) against the JAX package's
`tinyram_tpu/poly/mxu_ntt.py`, limb for limb (tolerance 0: the arithmetic
is exact).

The same numpy-seeded inputs go through both: the digit slicing, the DFT
digit tables, the column fold at the reference's bound (every column just
below 2^27), and `ntt_mxu` at n = 8 (one stage) and n = 256 (the four-step
split into two stages of 16), forward and inverse.  The JAX `ntt_mxu`
compiles for ~10-25 s a case on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyram_tpu.field import FP as JFP
from tinyram_tpu.poly import mxu_ntt as jmxu
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.poly import cuda_mxu, mxu_ntt
from tinyram_tpu_torch.poly.ntt import ntt

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them


def _limbs(shape, seed):
    """Canonical field elements (< 2^254) as (16, *shape) uint32 limbs."""
    limbs = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(16,) + tuple(shape)).astype(np.uint32)
    limbs[15] &= 0x3FFF
    return limbs


def _port(limbs):
    return torch.as_tensor(limbs.view(np.int32))


def _same(port, jax_arr):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(jax_arr).astype(np.int64))


def test_limbs_to_digits7_matches_jax():
    x = _limbs((5, 7), 1)
    x[:, 0, 0] = 0xFFFF  # every digit of the top limb set
    got = mxu_ntt.limbs_to_digits7(_port(x))
    assert got.dtype == torch.int8 and got.shape == (37, 5, 7)
    _same(got, jmxu.limbs_to_digits7(jnp.asarray(x)))


@pytest.mark.parametrize("log_r,inverse,scale",
                         [(1, False, 1), (3, True, 1), (5, False, 7)])
def test_dft_digit_matrix_matches_jax(log_r, inverse, scale):
    got = mxu_ntt._dft_digit_matrix("Fp", log_r, inverse, scale)
    want = jmxu._dft_digit_matrix("Fp", log_r, inverse, scale)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_digits_cols_to_mont_matches_jax():
    rng = np.random.default_rng(2)
    cols = rng.integers(0, 1 << 27, size=(73, 40)).astype(np.int32)
    cols[:, 0] = (1 << 27) - 1  # the bound in every column
    cols[:, 1] = 0
    got = mxu_ntt.digits_cols_to_mont("Fp", torch.as_tensor(cols))
    _same(got, jmxu.digits_cols_to_mont("Fp", jnp.asarray(cols)))


@pytest.mark.parametrize("log_r,inverse", [(3, False), (7, True)])
def test_dft_stage_matches_jax(log_r, inverse):
    x = _limbs((1 << log_r, 3), 3 + log_r)
    got = mxu_ntt.dft_stage(_port(x), "Fp", log_r, inverse)
    _same(got, jmxu.dft_stage(jnp.asarray(x), "Fp", log_r, inverse))


@pytest.mark.parametrize("n", [8, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_mxu_matches_jax(n, inverse):
    a = _limbs((n,), n + int(inverse))
    got = mxu_ntt.ntt_mxu(FP, _port(a), inverse)
    _same(got, jmxu.ntt_mxu(JFP, jnp.asarray(a), inverse=inverse))
    # and the butterfly NTT of the port (the function is one)
    assert torch.equal(got, ntt(FP, _port(a), inverse))


def test_ntt_mxu_batched_columns_match_radix2():
    a = _port(_limbs((3, 512), 9))
    assert torch.equal(mxu_ntt.ntt_mxu(FP, a), ntt(FP, a))


def test_ntt_method_switch():
    a = _port(_limbs((16,), 4))
    # on the CPU every method runs the radix-2 stages
    assert torch.equal(ntt(FP, a, method="mxu"), ntt(FP, a, method="b2"))
    with pytest.raises(ValueError):
        ntt(FP, a, method="pallas")


def test_m1_wrapper_rejects_what_the_kernel_does_not_take():
    x = _port(_limbs((256, 2), 5))
    with pytest.raises(ValueError):  # radix above R_MAX
        cuda_mxu.dft_stage_m1(x, "Fp", 8, False)
    with pytest.raises(ValueError):  # radix not the stated one
        cuda_mxu.dft_stage_m1(x[:, :128], "Fp", 6, False)
    with pytest.raises(ValueError):  # neither the CPU nor a card
        cuda_mxu.dft_stage_m1(x[:, :4].to("meta"), "Fp", 2, False)
