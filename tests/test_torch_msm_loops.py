"""The MSM's two sequential loops as one-launch forms: B3s (bucket scan)
and B5l (double-and-add ladder).

Their plain versions (what the wrappers run on a CPU tensor: the Python
loops over B3's and B5/B6's plain steps) against the JAX package's scan
bodies run by `jax.lax.scan`: `tinyram_tpu/curve/msm.py`'s bucket-scan
step (`_mixed_select`, select(same, acc + (qx, qy, 1), (qx, qy, 1))) and
its ladder step (`_ops`: acc = 2·acc; acc = select(bit, P + acc, acc)),
limb for limb, tolerance 0 (exact arithmetic).  Then `msm_many` on the
bit-serial path, which now runs through B5l, against the affine host
oracle.  Sizes stay small: at most 64 lanes and 8 steps.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyram_tpu.curve import vesta as jv
from tinyram_tpu_torch.curve import cuda_point as cp
from tinyram_tpu_torch.curve import host
from tinyram_tpu_torch.curve.msm import msm_many
from tinyram_tpu_torch.curve.vesta import PointBatch, from_affine_host, to_affine_host
from tinyram_tpu_torch.field import FP, FQ
from tinyram_tpu_torch.ipa.srs import _hash_to_curve

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

# curve/__init__ re-exports the function `msm` over the module name
jmsm = importlib.import_module("tinyram_tpu.curve.msm")


@pytest.fixture(scope="module")
def pool():
    pts = [_hash_to_curve(b"torch-msm-loops", i) for i in range(8)]
    return pts + [host.neg(p) for p in pts]


def _jax(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _eq(port, jax_pt):
    for a, b in zip(port, jax_pt):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(b).astype(np.int64))


def _scan_inputs(pool, L, M, seed):
    """(same (L, M), sx, sy (L, 16, M)) with an all-false, an all-true and
    mixed columns (L >= 5); on lanes 0..3, step 3 adds -P to an
    accumulator P, so the accumulator is the identity there and step 4
    adds to it."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 8, size=(L, M))
    same = rng.random((L, M)) < 0.5
    neg = np.zeros((L, M), dtype=bool)
    if L >= 5:
        same[1] = False
        same[2] = True
        same[2, :4], same[3, :4], same[4, :4] = False, True, True
        idx[3, :4] = idx[2, :4]
        neg[3, :4] = True
    pts = [[pool[int(idx[s, m]) + (8 if neg[s, m] else 0)] for m in range(M)]
           for s in range(L)]
    aff = [from_affine_host(row) for row in pts]
    sx = torch.stack([a.x for a in aff])
    sy = torch.stack([a.y for a in aff])
    return torch.as_tensor(same), sx, sy


@pytest.mark.parametrize("L,M", [(1, 5), (6, 40)])
def test_scan_plain_matches_jax_bucket_scan(pool, L, M):
    same, sx, sy = _scan_inputs(pool, L, M, seed=L)
    ys = cp.padd_select_mixed_scan(same, sx, sy)
    assert all(c.shape == (L, 16, M) for c in ys)
    step_fn = jmsm._mixed_select()

    def step(acc, inp):
        s, cx, cy = inp
        acc = step_fn(s, acc, cx, cy)
        return acc, acc

    _, want = jax.lax.scan(step, jv.identity((M,)),
                           (jnp.asarray(same.numpy()), _jax(sx), _jax(sy)))
    _eq(ys, want)
    if L > 4:  # P + (-P) left the identity on lanes 0..3 at step 3
        assert (ys.z[3, :, :4] == 0).all()


def test_scan_one_step_is_b3(pool):
    """B3s from the identity for one step equals B3 from an identity acc."""
    same, sx, sy = _scan_inputs(pool, 1, 12, seed=3)
    ident = PointBatch(FQ.zeros((12,)), FQ.ones((12,)), FQ.zeros((12,)))
    one = cp.padd_select_mixed(same[0], ident, sx[0], sy[0])
    ys = cp.padd_select_mixed_scan(same, sx, sy)
    for a, b in zip(one, ys):
        assert torch.equal(a, b[0])


@pytest.mark.parametrize("R", [1, 8])
def test_ladder_plain_matches_jax_ladder(pool, R):
    rng = np.random.default_rng(10 + R)
    n = 24
    pts = [None if i % 5 == 2 else pool[int(j)]
           for i, j in enumerate(rng.integers(0, 16, n))]  # identity points
    p = from_affine_host(pts)
    z = FQ.encode([int(v) | 1 for v in rng.integers(1, 1 << 62, n)])
    p = PointBatch(FQ.mul(p.x, z), FQ.select(FQ.is_zero(p.z), p.y, FQ.mul(p.y, z)),
                   FQ.mul(p.z, z))  # projective, identity lanes kept (0 : y : 0)
    bits = rng.random((R, n)) < 0.5
    bits[:, 0] = True
    bits[:, 1] = False
    got = cp.padd_select_ladder(torch.as_tensor(bits), p)
    _padd, _psel, _pdbl = jmsm._ops()
    jp = jv.PointBatch(*(_jax(c) for c in p))

    def step(acc, bit):
        acc = _pdbl(acc)
        return _psel(bit, jp, acc), None

    want, _ = jax.lax.scan(step, jv.identity((n,)), jnp.asarray(bits))
    _eq(got, want)
    # the ladder on a 2-D batch is the same per lane
    got2 = cp.padd_select_ladder(torch.as_tensor(bits).reshape(R, 4, 6),
                                 PointBatch(*(c.reshape(16, 4, 6) for c in p)))
    _eq(PointBatch(*(c.reshape(16, n) for c in got2)), want)


def test_ladder_with_no_steps_is_identity(pool):
    p = from_affine_host(pool[:3])
    out = cp.padd_select_ladder(torch.zeros((0, 3), dtype=torch.bool), p)
    assert to_affine_host(out) == [None] * 3


def test_msm_many_small_path_with_identity_points(pool):
    """(16, B, N) scalars on the bit-serial path (B5l on the card) against
    the affine host oracle: identity points, zero scalars, P and -P."""
    rng = np.random.default_rng(12)
    n, B = 10, 2
    pts = [pool[int(j)] for j in rng.integers(0, 16, n)]
    pts[1] = None
    pts[4], pts[5] = pool[2], host.neg(pool[2])
    scal = [[int(v) % FP.modulus for v in rng.integers(0, 1 << 62, n)]
            for _ in range(B)]
    scal[0][4] = scal[0][5]
    scal[1][0] = 0
    stack = torch.stack([FP.encode(s, to_mont=False) for s in scal], dim=1)
    got = to_affine_host(msm_many(stack, from_affine_host(pts)))
    want = []
    for s in scal:
        acc = None
        for k, pt in zip(s, pts):
            acc = host.add(acc, host.scalar_mul(k, pt))
        want.append(acc)
    assert got == want


def test_loop_wrappers_reject_other_devices():
    z = torch.zeros((2, 16, 4), dtype=torch.int32, device="meta")
    same = torch.zeros((2, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        cp.padd_select_mixed_scan(same, z, z)
    p = PointBatch(z[0], z[0], z[0])
    with pytest.raises(ValueError):
        cp.padd_select_ladder(same, p)
