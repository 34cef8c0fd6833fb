"""The MSM's affine-input check, the c = 15 plan of a 2^16-point MSM, and
the adversarial scalars of `tinyram_tpu_torch.verify_msm`, on the CPU.

- `check_affine=True` (the twin of the JAX `_check_affine_precondition`,
  there behind `TINYRAM_DEBUG`) raises on a batch with one projective lane
  and passes affine-or-identity input, as the JAX check does.
- The pieces of the c = 15 plan equal the JAX package's: `signed_digits`,
  `plan(2^16, 18)` against `_plan_impl(2^16, 18, 2^22, 2^15)` and
  `choose_window_bits`.
- The all-equal and edge scalars of `verify_msm.cases` go through the
  Pippenger pipeline at a small plan (every lane of a window in one bucket:
  the carry fixup's longest chain) and equal the JAX host oracle
  `curve/host.py` `msm`, as do `verify_msm`'s own host references.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyram_tpu.curve import host as jhost
from tinyram_tpu.curve import vesta as jv
from tinyram_tpu_torch import verify_msm
from tinyram_tpu_torch.curve import PointBatch, from_affine_host, to_affine_host
from tinyram_tpu_torch.field import FP, FQ
from tinyram_tpu_torch.ipa.srs import _hash_to_curve

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

jmsm = importlib.import_module("tinyram_tpu.curve.msm")
tmsm = importlib.import_module("tinyram_tpu_torch.curve.msm")

N = 32


@pytest.fixture(scope="module")
def pts():
    return [_hash_to_curve(b"msm-check", i) for i in range(N)]


def _projective_lane(pts, lane: int) -> PointBatch:
    """`pts` with `lane` scaled to (λx : λy : λ), the same point."""
    p = from_affine_host(pts, "cpu")
    lam = FQ.encode([7] * len(pts), device="cpu")
    one = FQ.ones((len(pts),), "cpu")
    take = torch.arange(len(pts)) == lane
    return PointBatch(*(torch.where(take, FQ.mul(c, lam), c)
                        for c in (p.x, p.y, one)))


def _jax(p: PointBatch):
    return jv.PointBatch(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in p))


def test_check_affine_raises_on_a_projective_lane(pts, monkeypatch):
    bad = _projective_lane(pts, 5)
    assert to_affine_host(bad) == pts  # the same points, z != 1 on lane 5
    sc = FP.encode(list(range(N)), to_mont=False)
    with pytest.raises(ValueError, match="affine-or-identity"):
        tmsm.msm(sc, bad, check_affine=True)
    with pytest.raises(ValueError, match="affine-or-identity"):
        tmsm.msm_many(sc[:, None], bad, check_affine=True)
    monkeypatch.setenv("TINYRAM_DEBUG", "1")
    with pytest.raises(ValueError) as jerr:
        jmsm._check_affine_precondition(_jax(bad))
    with pytest.raises(ValueError) as terr:
        tmsm.check_affine_precondition(bad)
    assert str(terr.value) == str(jerr.value)


def test_check_affine_passes_affine_or_identity(pts, monkeypatch):
    ok = from_affine_host(pts[:7] + [None] + pts[8:], "cpu")
    tmsm.check_affine_precondition(ok)
    monkeypatch.setenv("TINYRAM_DEBUG", "1")
    jmsm._check_affine_precondition(_jax(ok))


def test_signed_digits_c15_match_jax():
    limbs = np.random.default_rng(15).integers(0, 1 << 16, size=(16, 64))
    limbs[15] &= 0x3FFF
    limbs[:, 0] = [int(x) for x in FP.encode([FP.modulus - 1], to_mont=False)[:, 0]]
    got = tmsm.signed_digits(torch.as_tensor(limbs.astype(np.int32)), 15)
    want = jmsm.signed_digits(jnp.asarray(limbs.astype(np.uint32)), 15)
    assert got[0].shape == (18, 64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_plan_2_16_matches_jax():
    got = tmsm.plan(1 << 16, 18)
    assert got == jmsm._plan_impl(1 << 16, 18, 1 << 22, 1 << 15)
    assert got[:3] == (18, 1792, 37)


@pytest.mark.parametrize("log_n", [14, 16, 17, 20])
def test_choose_window_bits_matches_jax(log_n):
    n = 1 << log_n
    assert tmsm.choose_window_bits(n) == jmsm.choose_window_bits(n)
    assert tmsm.choose_window_bits(n) == {14: 13, 16: 15, 17: 16, 20: 16}[log_n]


@pytest.mark.parametrize("case", ["skew(all-equal)", "edge"])
def test_pippenger_on_adversarial_scalars(pts, case):
    """32 points at c = 8 in a plan of 8 windows a group and 4 chunk lanes
    a window (group_log2 8, lanes_log2 6)."""
    scalars = verify_msm.cases(N)[case]
    c = tmsm.choose_window_bits(N)
    assert tmsm.plan(N, -(-256 // c), 8, 6)[:3] == (8, 4, 8)
    sc = FP.encode(scalars, to_mont=False)
    out = tmsm._msm_pippenger(sc[:, None], from_affine_host(pts, "cpu"), c, 8, 6)
    want = jhost.msm(scalars, pts)
    assert to_affine_host(out) == [want]
    assert verify_msm.oracles({case: scalars}, pts) == {case: want}


def test_host_references_of_every_case(pts):
    """`verify_msm.oracles` on the four cases at once (the sum of the
    selected points, s · ΣP, and the Jacobian combinations) equals the JAX
    host oracle on each."""
    vectors = verify_msm.cases(N)
    assert set(vectors["tiny(selector-like)"]) == {0, 1}
    assert verify_msm.oracles(vectors, pts) == \
        {name: jhost.msm(scalars, pts) for name, scalars in vectors.items()}
