"""The batched-affine MSM bucket scan and the batched inverse of
`tinyram_tpu_torch/curve/msm.py` (the plain versions of kernels A1 and
A2, what their wrappers in `curve/cuda_affine.py` run on a CPU tensor)
against the JAX package's `tinyram_tpu/curve/msm.py`, limb for limb
(tolerance 0: the arithmetic is exact).

`batch_inv` at a width above `stop_width` and odd, with substituted lanes
and with a zero left in (the reference's result there is pinned: every
lane of the zero's stop-level node is zero); the affine
`_group_bucket_sums` against `_group_bucket_sums_inner(..., affine=True)`
on a plan of 250 points, 2 windows, 32 lanes a window and L = 8 steps,
whose digits hit every case of the scan (restart, chord, doubling of a
repeated point, cancel of P and -P, identity inputs, padding); and the
port's `_msm_pippenger(affine=True)` against `affine=False` in affine form.
Each scan step runs one Fermat inversion of ~380 plain products, so the
plans keep L small; the reference's ladder runs as its field's `inv`
(`_quick_ladder`: the same exponent and bits, not unrolled, so that it
compiles in seconds).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyram_tpu.curve import vesta as jv
from tinyram_tpu_torch.curve import cuda_affine, host
from tinyram_tpu_torch.curve.vesta import PointBatch, from_affine_host, to_affine_host
from tinyram_tpu_torch.field import FQ
from tinyram_tpu_torch.ipa.srs import _hash_to_curve

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

# curve/__init__ re-exports the function `msm` over the module name
jmsm = importlib.import_module("tinyram_tpu.curve.msm")
tmsm = importlib.import_module("tinyram_tpu_torch.curve.msm")


@pytest.fixture(scope="module")
def pool():
    return [_hash_to_curve(b"torch-msm-affine", i) for i in range(6)]


def _j(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _same(port, jax_arr):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(jax_arr).astype(np.int64))


def _fq_elements(n, seed):
    vals = np.random.default_rng(seed).integers(1, 1 << 62, size=n)
    return FQ.encode([int(v) for v in vals])


def _quick_ladder(monkeypatch):
    """The reference's `_fermat_unrolled` is its field's square-and-multiply
    Fermat inverse unrolled 32-fold, whose compile takes minutes here (over
    100 s alone, longer inside the scan): run the same ladder as the
    reference field's `inv` (a^(p-2), the same bits, a plain fori_loop)."""
    monkeypatch.setattr(jmsm, "_fermat_unrolled", jmsm.FQ.inv)


@pytest.mark.parametrize("substituted", [True, False])
def test_batch_inv_matches_jax(substituted, monkeypatch):
    _quick_ladder(monkeypatch)
    n = 601  # > stop_width 256, odd: the tree pads with one twice
    d = _fq_elements(n, 5)
    d[:, [7, 600]] = 0
    if substituted:  # as the scan does: zeros become one
        d = FQ.select(FQ.is_zero(d), FQ.ones((n,)), d)
    got = tmsm.batch_inv(d)
    _same(got, jmsm.batch_inv(_j(d)))
    # the wrapper of A2 runs this plain version on a CPU tensor
    assert torch.equal(cuda_affine.batch_inverse(d), got)
    zero_out = FQ.is_zero(got).nonzero().flatten().tolist()
    if substituted:
        assert zero_out == []
        assert (FQ.mul(got, d) == FQ.ones((n,))).all()
    else:
        # 601 -> 301 -> 151 lanes: nodes of 4 lanes at the stop level; the
        # nodes of the two zeros are zero, every other lane is inverted
        assert cuda_affine.group_log2(n) == 2
        assert zero_out == [4, 5, 6, 7, 600]
        keep = torch.ones(n, dtype=torch.bool)
        keep[zero_out] = False
        assert (FQ.mul(got, d)[:, keep] == FQ.ones((int(keep.sum()),))).all()


def _plan_inputs(pool):
    """Two windows of digits over 250 points (c = 5: buckets 0..16, spill
    17), with their cases at the start of each window's first chunk."""
    rng = np.random.default_rng(11)
    n = 250
    idx = rng.integers(0, len(pool), size=n)
    pts = [pool[int(i)] for i in idx]
    digits = rng.integers(1, 17, size=(2, n))
    signs = rng.random((2, n)) < 0.5
    # window 0, bucket 0: P, P (doubling), then a third point (chord)
    pts[1] = pts[0]
    digits[0, [0, 1, 2]] = 0
    # window 1, bucket 0: Q, -Q (cancel), then R (from the identity)
    pts[4], pts[5], pts[6] = pool[1], host.neg(pool[1]), pool[2]
    digits[1, [4, 5, 6]] = 0
    signs[:, :7] = False
    # identity inputs (routed to the spill bucket), and 6 padding lanes
    pts[20] = None
    pts[77] = None
    return (torch.as_tensor(digits), torch.as_tensor(signs),
            from_affine_host(pts))


def test_affine_bucket_sums_match_jax(pool, monkeypatch):
    _quick_ladder(monkeypatch)
    digits, signs, pts = _plan_inputs(pool)
    lanes, L, n_buckets = 32, 8, 17
    got = tmsm._group_bucket_sums(digits, signs, pts, lanes, L, n_buckets,
                                  affine=True)
    want = jmsm._group_bucket_sums_inner(
        jnp.asarray(digits.numpy().astype(np.int32)),
        jnp.asarray(signs.numpy()), jv.PointBatch(*(_j(c) for c in pts)),
        5, lanes, L, n_buckets, affine=True)
    # every bucket; the spill bucket (slot n_buckets) collects the padding
    # and the identity inputs, the reference leaves garbage there and the
    # port the identity, and nothing reads it
    for a, b in zip(got, want):
        _same(a[..., :n_buckets], b[..., :n_buckets])
    # the projective scan gives the same sums (not the same coordinates)
    proj = tmsm._group_bucket_sums(digits, signs, pts, lanes, L, n_buckets)
    for w in range(2):
        assert to_affine_host(
            PointBatch(*(c[:, w, :n_buckets] for c in got))) == \
            to_affine_host(PointBatch(*(c[:, w, :n_buckets] for c in proj)))


def test_affine_scan_cases(pool):
    """The scan's case split on one lane each: restart, doubling, chord,
    cancel to the canonical identity, restart from the identity."""
    P, Q = pool[0], pool[1]
    seq = [P, P, Q, host.neg(host.add(host.add(P, P), Q)), Q]
    same = torch.tensor([[False], [True], [True], [True], [True]])
    aff = [from_affine_host([p]) for p in seq]
    sx = torch.stack([a.x for a in aff])
    sy = torch.stack([a.y for a in aff])
    xs, ys, infs = cuda_affine.affine_scan(same, sx, sy)
    assert infs[:, 0].tolist() == [False, False, False, True, False]
    got = to_affine_host(PointBatch(xs[:, :, 0].T, ys[:, :, 0].T,
                                    FQ.ones((5,))))
    assert got[:3] == [P, host.add(P, P), host.add(host.add(P, P), Q)]
    assert got[4] == Q
    # the identity lane is (0, 1)
    assert FQ.is_zero(xs[3]).all()
    assert torch.equal(ys[3], FQ.ones((1,)))


def test_affine_pippenger_matches_projective(pool):
    rng = np.random.default_rng(3)
    n = 256
    pts = [pool[int(i)] for i in rng.integers(0, len(pool), size=n)]
    pts[9] = None
    sc = rng.integers(0, 1 << 16, size=(16, 2, n)).astype(np.int32)
    sc[15] &= 0x3FFF
    sc = torch.as_tensor(sc)
    P = from_affine_host(pts)
    # c = 4: 64 windows a column, 128 of both columns in one group of 32
    # lanes a window, L = 8
    args = (sc, P, 4, 22, 12)
    got = tmsm._msm_pippenger(*args, affine=True)
    want = tmsm._msm_pippenger(*args, affine=False)
    assert to_affine_host(got) == to_affine_host(want)


def test_affine_default_lanes():
    assert tmsm._lanes_log2(None, True) == 17
    assert tmsm._lanes_log2(None, False) == 15
    assert tmsm._lanes_log2(12, True) == 12


def test_affine_wrappers_reject_other_devices():
    d = FQ.ones((4,)).to("meta")
    with pytest.raises(ValueError):
        cuda_affine.batch_inverse(d)
    with pytest.raises(ValueError):
        cuda_affine.affine_scan(torch.ones((1, 4), dtype=torch.bool),
                                d[None], d[None])
