"""The rooflines' work functions against counts made by hand."""

import math

import pytest

from benchmark import work
from benchmark.reference.tinyram_cs import TinyRamCS


def test_product_rate_from_the_published_peaks():
    pk = work.peaks()
    imad = 132 * 1.98e9 * 64  # SMs x clock x IMAD lanes
    assert work.products_per_s(pk) == pytest.approx(imad / 27 + 1.979e15 / 2048)


def test_msm_additions_by_hand():
    # m = 2: c = 5 gives ceil(255/5)*2 + 32 = 134, the least over c
    assert work.msm_additions(2) == 134
    # m = 4: c = 5: 51*4 + 32 = 236; c = 6: 43*4 + 64 = 236; c = 4: 64*4+16 = 272
    assert work.msm_additions(4) == 236
    assert work.msm_additions(1) == 0
    # m = 2^17: c = 17 gives 15 * 2^17 + 2^17
    assert work.msm_additions(1 << 17) == 16 * (1 << 17)


def test_ntt_seconds_by_hand():
    pk = work.peaks()
    # 8 points: 12 butterflies' products, or 16 elements of 32 B moved
    ops = 12 / work.products_per_s(pk)
    data = 16 * 32 / pk["hbm_bytes_per_s"]
    assert work.ntt_seconds(8, pk) == pytest.approx(max(ops, data))
    assert work.ntt_seconds(1 << 17, pk) == pytest.approx(
        (1 << 18) * 32 / pk["hbm_bytes_per_s"])


def test_proof_counts_by_hand():
    cs = TinyRamCS(24, 8, k=17).cs
    # 100 instance + 190 advice + 9 lookups x (A', S', z) + LogUp (7 helpers,
    # h_T, m, z) + 4 quotient chunks + the multiopen's Q
    assert work.commitments(cs) == 100 + 190 + 27 + 10 + 4 + 1
    pk = work.peaks()
    msm = work.proof_msm_seconds(cs, 17, pk)
    ipa = sum(2 * work.msm_seconds(1 << (16 - j), pk) for j in range(17))
    assert msm == pytest.approx(332 * work.msm_seconds(1 << 17, pk) + ipa)
    # interpolated: 290 + 37; extended: the 290 queried instance and advice
    # columns + 37, and the quotient; 4 cosets of 2^17 each
    ntt = work.proof_ntt_seconds(cs, 17, pk)
    one = work.ntt_seconds(1 << 17, pk)
    assert ntt == pytest.approx(327 * one + (327 + 1) * 4 * one)
    assert math.isfinite(ntt) and ntt > 0
