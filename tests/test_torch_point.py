"""Point kernels' plain versions and the port's MSM.

B3-B6's plain versions (what the wrappers run on a CPU tensor) against
`tinyram_tpu.curve.vesta` add_mixed / add / select(add) / double, limb for
limb, on batches with identity lanes.  The port's msm / msm_many against
the affine host oracle `curve/host.py`: identity inputs, duplicates,
P + (-P), zero scalars, on the bit-serial path and on Pippenger (N just
above 2^15).  Tolerance 0 throughout (exact arithmetic).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinyram_tpu.curve import vesta as jv
from tinyram_tpu_torch.curve import cuda_point as cp
from tinyram_tpu_torch.curve import host
from tinyram_tpu_torch.curve import host_jacobian as hj
from tinyram_tpu_torch.curve.vesta import PointBatch, from_affine_host, to_affine_host
from tinyram_tpu_torch.field import FP, FQ
from tinyram_tpu_torch.ipa.srs import _hash_to_curve

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

# curve/__init__ re-exports the function `msm` over the module name
tmsm = importlib.import_module("tinyram_tpu_torch.curve.msm")
R_SCALAR = FP.modulus  # Vesta's group order (its scalar field is Fp)


@pytest.fixture(scope="module")
def pool():
    """16 distinct affine points, then their negations."""
    pts = [_hash_to_curve(b"torch-port-test", i) for i in range(16)]
    return pts + [host.neg(p) for p in pts]


def _batch(pool, n, seed, ident_every=7):
    """n projective points (random z) from the pool, every ident_every-th
    lane the identity; returns the port batch, the JAX batch, host points."""
    rng = np.random.default_rng(seed)
    pts = [None if i % ident_every == 3 else pool[int(j)]
           for i, j in enumerate(rng.integers(0, len(pool), n))]
    aff = from_affine_host(pts)
    z_vals = [int(v) % FQ.modulus or 1
              for v in rng.integers(1, 1 << 62, n)]
    z = FQ.encode(z_vals)
    proj = PointBatch(FQ.mul(aff.x, z), FQ.mul(aff.y, z),
                      FQ.mul(aff.z, z))  # identity lanes stay (0 : z : 0)
    proj = PointBatch(proj.x, FQ.select(FQ.is_zero(aff.z), aff.y, proj.y),
                      proj.z)
    return proj, _to_jax(proj), pts


def _to_jax(p):
    return jv.PointBatch(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in p))


def _eq(port, jax_pt):
    for a, b in zip(port, jax_pt):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(b).astype(np.int64))


def test_point_plain_versions_match_jax_vesta(pool):
    n = 64
    p, jp, _ = _batch(pool, n, seed=1)
    q, jq, _ = _batch(pool, n, seed=2, ident_every=5)
    mask = np.random.default_rng(3).random(n) < 0.5
    tmask, jmask = torch.as_tensor(mask), jnp.asarray(mask)
    # B4, B5, B6
    _eq(cp.padd(p, q), jv.add(jp, jq))
    _eq(cp.padd_select(tmask, p, q), jv.select(jmask, jv.add(jp, jq), jq))
    _eq(cp.pdouble(p), jv.double(jp))
    # B3: q affine and finite
    qa = from_affine_host([pool[i % len(pool)] for i in range(n)])
    jqa = _to_jax(qa)
    lifted = jv.PointBatch(jqa.x, jqa.y, jqa.z)
    _eq(cp.padd_select_mixed(tmask, p, qa.x, qa.y),
        jv.select(jmask, jv.add_mixed(jp, jqa.x, jqa.y), lifted))
    # a 2-D batch goes through the same flattening
    p2 = PointBatch(*(c.reshape(16, 4, 16) for c in p))
    q2 = PointBatch(*(c.reshape(16, 4, 16) for c in q))
    out = cp.padd(p2, q2)
    _eq(PointBatch(*(c.reshape(16, n) for c in out)), jv.add(jp, jq))


def test_point_wrappers_reject_other_devices():
    z = torch.zeros((16, 4), dtype=torch.int32, device="meta")
    m = torch.zeros((4,), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        cp.padd(PointBatch(z, z, z), PointBatch(z, z, z))
    with pytest.raises(ValueError):
        cp.padd_select_mixed(m, PointBatch(z, z, z), z, z)


def test_host_jacobian_matches_affine_oracle(pool):
    """The host linear combinations (one inversion each) against the
    affine oracle: identity inputs, k = 0, 1, r - 1, r, doubling through
    an addition of equal points, and P + (-P)."""
    rng = np.random.default_rng(9)
    p, q = pool[0], pool[1]
    for k in [0, 1, 2, R_SCALAR - 1, R_SCALAR, *_scalars(rng, 6)]:
        for pt in (p, q, None):
            assert hj.scalar_mul(k, pt) == host.scalar_mul(k, pt)
    k1, k2 = _scalars(rng, 2)
    want = host.add(host.scalar_mul(k1, p), host.scalar_mul(k2, q))
    assert hj.lincomb([(k1, p), (k2, q)]) == want
    assert hj.lincomb([(k1, p), (k1, p)]) == host.scalar_mul(2 * k1, p)
    assert hj.lincomb([(k1, p), (k1, host.neg(p))]) is None
    assert hj.lincomb([(k1, p)], host.neg(host.scalar_mul(k1, p))) is None
    assert hj.lincomb([(0, p), (5, None)], q) == q
    assert hj.lincomb([]) is None


def _oracle(scalars, pts):
    acc = None
    for s, p in zip(scalars, pts):
        acc = host.add(acc, host.scalar_mul(s % R_SCALAR, p))
    return acc


def _grouped_oracle(scalars, idx, pool):
    """Σ s_i·pool[idx_i] via one scalar multiple per pool point."""
    sums = {}
    for s, j in zip(scalars, idx):
        if j >= 0:
            sums[j] = (sums.get(j, 0) + s) % R_SCALAR
    return _oracle(list(sums.values()), [pool[j] for j in sums])


def _scalars(rng, n):
    words = rng.integers(0, 1 << 62, size=(n, 5))
    return [sum(int(w) << (62 * i) for i, w in enumerate(row)) % R_SCALAR
            for row in words]


def test_msm_small_path_matches_host(pool):
    rng = np.random.default_rng(5)
    n = 24
    pts = [pool[int(j)] for j in rng.integers(0, len(pool), n)]
    pts[2] = None  # identity input
    pts[5], pts[6] = pool[0], host.neg(pool[0])  # P + (-P)
    pts[7] = pts[8] = pool[1]  # duplicates
    sc = _scalars(rng, n)
    sc[5] = sc[6]  # so P and -P cancel
    sc[9] = 0  # zero scalar
    got = tmsm.msm(FP.encode(sc, to_mont=False), from_affine_host(pts))
    assert to_affine_host(PointBatch(*(c[:, None] for c in got)))[0] == \
        _oracle(sc, pts)
    # batched: (16, B, N) scalars against one point set
    sc2 = [_scalars(rng, n) for _ in range(3)]
    sc2[1] = [0] * n  # an all-zero column commits to the identity
    stack = torch.stack([FP.encode(s, to_mont=False) for s in sc2], dim=1)
    got = to_affine_host(tmsm.msm_many(stack, from_affine_host(pts)))
    assert got == [_oracle(s, pts) for s in sc2]


def test_msm_pippenger_matches_host(pool):
    """N just above 2^15: the sorted chunked bucket scan (B3), the carry
    fixup (B5, B4), the weighted reduce and the window combine."""
    rng = np.random.default_rng(6)
    n = (1 << 15) + 40
    idx = rng.integers(0, len(pool), n)
    idx[::97] = -1  # identity inputs
    pts = [None if j < 0 else pool[int(j)] for j in idx]
    sc = _scalars(rng, n)
    for i in range(0, n, 13):
        sc[i] = 0  # zero scalars
    sc[1:40] = [sc[0]] * 39  # a long run of equal digits in every window
    got = tmsm.msm(FP.encode(sc, to_mont=False), from_affine_host(pts),
                   window_bits=15)
    assert to_affine_host(PointBatch(*(c[:, None] for c in got)))[0] == \
        _grouped_oracle(sc, [int(j) for j in idx], pool)
