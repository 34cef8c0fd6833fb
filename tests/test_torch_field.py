"""Port field arithmetic (tinyram_tpu_torch.field) against the JAX package.

Same inputs, made from a seed with numpy, go through `tinyram_tpu.field`
FP/FQ and the port's FP/FQ; every result must be equal limb for limb
(tolerance 0: the arithmetic is exact and both sides keep canonical limbs).
Kernel B1's plain version is held against the Pallas body `mont_mul_vecs`
run eagerly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinyram_tpu.field import FP as JFP
from tinyram_tpu.field import FQ as JFQ
from tinyram_tpu.field.pallas_mul import field_limbs, mont_mul_vecs
from tinyram_tpu_torch.field import FP, FQ
from tinyram_tpu_torch.field.cuda_mul import mont_mul, mont_mul_plain
from tinyram_tpu_torch.field.field import FP_PLAIN, FQ_PLAIN
from tinyram_tpu_torch.field.params import R, int_to_limbs

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

FIELDS = {"Fp": (JFP, FP, FP_PLAIN), "Fq": (JFQ, FQ, FQ_PLAIN)}


def _values(p: int, n: int, seed: int) -> list[int]:
    """Edge values 0, 1, p-1, R mod p, then seeded random ones in [0, p)."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.int64)
    rand = [sum(int(w) << (63 * i) for i, w in enumerate(row)) % p
            for row in words]
    return [0, 1, p - 1, R % p, 2, p - 2] + rand


def _limbs(vals) -> np.ndarray:
    return np.array([int_to_limbs(v) for v in vals], dtype=np.uint32).T


def _jax(arr: np.ndarray):
    return jnp.asarray(arr.astype(np.uint32))


def _torch(arr: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(arr.astype(np.int32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.int64)
    return np.asarray(x).astype(np.int64)


@pytest.fixture(params=sorted(FIELDS))
def fields(request):
    jf, tf, plain = FIELDS[request.param]
    a_vals = _values(jf.modulus, 250, seed=1)
    b_vals = list(reversed(_values(jf.modulus, 250, seed=2)))
    return jf, tf, plain, _limbs(a_vals), _limbs(b_vals)


def test_binary_ops_match_jax(fields):
    jf, tf, _, a, b = fields
    ja, jb, ta, tb = _jax(a), _jax(b), _torch(a), _torch(b)
    for name in ("add", "sub", "mul"):
        want = _np(getattr(jf, name)(ja, jb))
        got = _np(getattr(tf, name)(ta, tb))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_unary_ops_match_jax(fields):
    jf, tf, _, a, _ = fields
    ja, ta = _jax(a), _torch(a)
    for name in ("neg", "double", "square", "to_mont", "from_mont"):
        np.testing.assert_array_equal(
            _np(getattr(tf, name)(ta)), _np(getattr(jf, name)(ja)),
            err_msg=name,
        )
    np.testing.assert_array_equal(_np(tf.is_zero(ta)), _np(jf.is_zero(ja)))


def test_inverse_and_pow_match_jax(fields):
    jf, tf, _, a, _ = fields
    a = a[:, :24]  # Fermat: ~380 products per call
    ja, ta = _jax(a), _torch(a)
    got = _np(tf.inv(ta))
    np.testing.assert_array_equal(got, _np(jf.inv(ja)))
    assert (got[:, 0] == 0).all()  # inv(0) = 0
    np.testing.assert_array_equal(
        _np(tf.pow_const(ta, 0x1234567)), _np(jf.pow_const(ja, 0x1234567))
    )


def test_broadcast_select_and_const_match_jax(fields):
    jf, tf, _, a, b = fields
    a3 = a[:, :60].reshape(16, 3, 20)
    col = b[:, :1].reshape(16, 1, 1)
    np.testing.assert_array_equal(
        _np(tf.mul(_torch(a3), _torch(col))), _np(jf.mul(_jax(a3), _jax(col)))
    )
    np.testing.assert_array_equal(
        _np(tf.add(_torch(col), _torch(a3))), _np(jf.add(_jax(col), _jax(a3)))
    )
    mask = np.random.default_rng(3).random(a.shape[1]) < 0.5
    np.testing.assert_array_equal(
        _np(tf.select(torch.as_tensor(mask), _torch(a), _torch(b))),
        _np(jf.select(jnp.asarray(mask), _jax(a), _jax(b))),
    )
    np.testing.assert_array_equal(
        _np(tf.const(12345, 2)), _np(jf.const(12345, 2))
    )


def test_encode_decode_match_jax(fields):
    jf, tf, _, a, _ = fields
    vals = _values(jf.modulus, 40, seed=4)
    np.testing.assert_array_equal(_np(tf.encode(vals)), _np(jf.encode(vals)))
    small = np.arange(0, 5000, 7, dtype=np.int64)
    np.testing.assert_array_equal(_np(tf.encode(small)), _np(jf.encode(small)))
    assert tf.decode(tf.encode(vals)) == [v % jf.modulus for v in vals]
    np.testing.assert_array_equal(
        tf.decode_i64(tf.encode(small)), jf.decode_i64(jf.encode(small))
    )


def test_b1_plain_matches_pallas_body(fields):
    """B1's plain version against the Pallas kernel body, run eagerly."""
    jf, tf, plain, a, b = fields
    want = jnp.stack(mont_mul_vecs(
        [_jax(a)[i] for i in range(16)], [_jax(b)[i] for i in range(16)],
        field_limbs(jf.params), np.uint32(jf.params.n0_inv),
    ))
    got = mont_mul_plain(_torch(a), _torch(b), tf.params)
    np.testing.assert_array_equal(_np(got), _np(want))
    # the wrapper takes the plain version for CPU tensors, as does FP_PLAIN
    np.testing.assert_array_equal(
        _np(mont_mul(_torch(a), _torch(b), tf.params)), _np(want)
    )
    np.testing.assert_array_equal(_np(plain.mul(_torch(a), _torch(b))),
                                  _np(want))


def test_b1_wrapper_rejects_other_devices_and_types():
    a = torch.zeros((16, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        mont_mul(a, a, FP.params)
    b = torch.zeros((16, 8), dtype=torch.int64)
    with pytest.raises(TypeError):
        mont_mul(b, b, FP.params)
