"""The MSM's reduce loops as one-launch forms: B4s (the weighted reduce's
suffix scan), B6h (the window combine, Horner) and B6 with a count (the
doubling chains).

Their plain versions (what the wrappers run on a CPU tensor: the Python
loops over B4's and B6's plain steps) against the JAX package on the CPU,
limb for limb, tolerance 0 (exact arithmetic): B6h against
`tinyram_tpu/curve/msm.py` `_combine_windows_inner` (its `fori_loop`);
B4s against `_weighted_bucket_reduce_inner`'s scan step run by
`jax.lax.scan`, and the port's `_weighted_bucket_reduce_signed` against the
JAX one; `pdouble(p, times=r)` against r JAX doublings.  Identity points
and P + (-P) are among the inputs.  Sizes stay tiny: c <= 4, at most 4
windows and 8 lanes.
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
from tinyram_tpu_torch.curve.vesta import PointBatch, from_affine_host, to_affine_host
from tinyram_tpu_torch.field import FQ
from tinyram_tpu_torch.ipa.srs import _hash_to_curve

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

# curve/__init__ re-exports the function `msm` over the module name
jmsm = importlib.import_module("tinyram_tpu.curve.msm")
tmsm = importlib.import_module("tinyram_tpu_torch.curve.msm")


@pytest.fixture(scope="module")
def pool():
    return [_hash_to_curve(b"torch-msm-reduce", i) for i in range(8)]


def _projective(pts, seed):
    """Host points (None = identity) -> a projective batch with random z;
    identity lanes stay (0 : 1 : 0)."""
    rng = np.random.default_rng(seed)
    aff = from_affine_host(pts)
    z = FQ.encode([int(v) | 1 for v in rng.integers(1, 1 << 62, len(pts))])
    ident = FQ.is_zero(aff.z)
    return PointBatch(FQ.mul(aff.x, z), FQ.select(ident, aff.y, FQ.mul(aff.y, z)),
                      FQ.mul(aff.z, z))


def _random_points(pool, shape, seed, ident_every=5):
    """A projective batch of `shape` from the pool and its negations, every
    ident_every-th point the identity."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    pts = [None if i % ident_every == 2 else
           (pool[int(j) % 8] if j < 8 else host.neg(pool[int(j) % 8]))
           for i, j in enumerate(rng.integers(0, 16, n))]
    return PointBatch(*(c.reshape((16,) + tuple(shape))
                        for c in _projective(pts, seed + 1)))


def _jax(p):
    return jv.PointBatch(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in p))


def _eq(port, jax_pt):
    for a, b in zip(port, jax_pt):
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("r", [0, 1, 5])
def test_pdouble_count_matches_jax_doublings(pool, r):
    p = _random_points(pool, (8,), seed=r)
    want = _jax(p)
    _pdbl = jmsm._ops()[2]
    for _ in range(r):
        want = _pdbl(want)
    _eq(cp.pdouble(p, times=r), want)
    # a 2-D batch is the same per lane
    got2 = cp.pdouble(PointBatch(*(c.reshape(16, 2, 4) for c in p)), times=r)
    _eq(PointBatch(*(c.reshape(16, 8) for c in got2)), want)


@pytest.mark.parametrize("S,lanes", [(1, 3), (4, 6)])
def test_suffix_scan_plain_matches_jax_scan(pool, S, lanes):
    """B4s against the JAX weighted reduce's scan step; on lane 0 the
    buckets P, -P at steps S-1, S-2 take acc through the identity."""
    b = _random_points(pool, (lanes, S), seed=10 * S + lanes)
    if S >= 2:
        pair = _projective([pool[3], host.neg(pool[3])], seed=7)
        for coord, val in zip(b, pair):
            coord[:, 0, S - 1], coord[:, 0, S - 2] = val[:, 0], val[:, 1]
    acc, tot = cp.padd_suffix_scan(b)
    _padd, _psel, _ = jmsm._ops()

    def step(carry, inp):  # tinyram_tpu/curve/msm.py:524-531
        jacc, jtot = carry
        cx, cy, cz, j = inp
        jacc = _padd(jacc, jv.PointBatch(cx, cy, cz))
        jtot = _psel(jnp.broadcast_to(j >= 1, jtot.x.shape[1:]), jacc, jtot)
        return (jacc, jtot), None

    jb = _jax(b)
    xs = tuple(jnp.moveaxis(c, -1, 0)[::-1] for c in jb) + (jnp.arange(S - 1, -1, -1),)
    ident = jv.identity((lanes,))
    (want_acc, want_tot), _ = jax.lax.scan(step, (ident, ident), xs)
    _eq(acc, want_acc)
    _eq(tot, want_tot)
    if S >= 2:  # acc = Σ b, tot = Σ j·b_j, as affine points
        got = to_affine_host(PointBatch(*(c[:, :1] for c in tot)))
        pts = [to_affine_host(PointBatch(*(c[:, 0, j:j + 1] for c in b)))[0]
               for j in range(S)]
        want = None
        for j, pt in enumerate(pts):
            want = host.add(want, host.scalar_mul(j, pt))
        assert got == [want]


@pytest.mark.parametrize("c", [3, 4])
def test_weighted_reduce_signed_matches_jax(pool, c):
    """The port's whole signed weighted reduce (B4s, the log-depth trees,
    B6 with a count) against the JAX package's."""
    nw = 3
    buckets = _random_points(pool, (nw, (1 << (c - 1)) + 2), seed=20 + c)
    got = tmsm._weighted_bucket_reduce_signed(buckets, c)
    _eq(got, jmsm._weighted_bucket_reduce_signed(_jax(buckets), c))


@pytest.mark.parametrize("nw,c,lanes", [(1, 1, 1), (3, 2, 5), (4, 4, 8)])
def test_horner_plain_matches_jax_combine(pool, nw, c, lanes):
    """B6h against the JAX `fori_loop`; with 3 windows, lane 0 is P at
    window 2 and -2^c P at window 1, so the accumulator passes through the
    identity before window 0 adds to it."""
    ws = _random_points(pool, (nw, lanes), seed=nw * 10 + c)
    if nw == 3:
        pair = _projective([pool[5], host.neg(host.scalar_mul(1 << c, pool[5]))],
                           seed=9)
        for coord, val in zip(ws, pair):
            coord[:, 2, 0], coord[:, 1, 0] = val[:, 0], val[:, 1]
    got = cp.pdouble_horner(ws, c)
    assert got.x.shape == (16, lanes)
    want = jmsm._combine_windows_inner(_jax(ws), c)
    _eq(got, want)
    _eq(tmsm._combine_windows(ws, c), want)  # the msm module's combine is B6h


def test_reduce_wrappers_reject_other_devices():
    z = torch.zeros((16, 3, 4), dtype=torch.int32, device="meta")
    p = PointBatch(z, z, z)
    with pytest.raises(ValueError):
        cp.padd_suffix_scan(p)
    with pytest.raises(ValueError):
        cp.pdouble_horner(p, 2)
    with pytest.raises(ValueError):
        cp.pdouble(p, times=3)
