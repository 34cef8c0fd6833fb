"""Port IPA commitment scheme (tinyram_tpu_torch.ipa) against the JAX package.

The SRS derivation must reproduce the JAX package's generators exactly (the
frozen hash of tests/test_golden.py); commitments must equal the affine host
oracle Σ c_i·G_i (+ blind·W) exactly; an opening made with a seeded random
stream must verify, and a tampered one must not.
"""

import hashlib
import random

import numpy as np
import torch

from tinyram_tpu.ipa import srs as jsrs
from tinyram_tpu_torch.convert import srs_from_numpy
from tinyram_tpu_torch.curve import PointBatch, host, to_affine_host
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.ipa import srs as tsrs
from tinyram_tpu_torch.ipa.ipa import commit, commit_many, open_poly, verify_open
from tinyram_tpu_torch.transcript import TranscriptReader, TranscriptWriter

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

P = FP.modulus


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def test_srs_generators_frozen_and_equal_to_jax():
    srs = tsrs.setup(3, device="cpu")
    pts = to_affine_host(PointBatch(srs.g.x[:, :2], srs.g.y[:, :2],
                                    srs.g.z[:, :2]))
    h = hashlib.sha256(repr(pts).encode()).hexdigest()
    assert h == (
        "1cc9fa9113d8b683c9b4e941a78398a7a7c2439010452771d552843feb340a84"
    ), "SRS generator derivation changed"
    assert srs.g_host == [jsrs._hash_to_curve(b"tinyram-tpu-srs-g", i)
                          for i in range(8)]
    assert srs.u_host == jsrs._hash_to_curve(b"tinyram-tpu-srs-u", 0)
    assert srs.w_host == jsrs._hash_to_curve(b"tinyram-tpu-srs-w", 0)
    assert to_affine_host(srs.g) == srs.g_host


def test_srs_from_numpy_carries_the_jax_srs():
    js = jsrs.setup(3)
    carried = srs_from_numpy(np.asarray(js.g.x), np.asarray(js.g.y),
                             np.asarray(js.g.z), js.u_host, js.w_host,
                             device="cpu")
    port = tsrs.setup(3, device="cpu")
    assert carried.k == 3 and carried.g_host == port.g_host
    assert (carried.u_host, carried.w_host) == (port.u_host, port.w_host)
    for a, b in zip(carried.g, port.g):
        assert a.dtype == b.dtype and bool((a == b).all())


def test_srs_disk_cache_round_trip(tmp_path):
    made = tsrs._gen_host(3, str(tmp_path))
    assert (tmp_path / "srs_vesta_k3.npz").exists()
    assert tsrs._gen_host(3, str(tmp_path)) == made
    assert made == tsrs._gen_host(3, None)


def _oracle(srs, coeffs, blind=0):
    acc = None
    for c, g in zip(coeffs, srs.g_host):
        acc = host.add(acc, host.scalar_mul(c, g))
    return host.add(acc, host.scalar_mul(blind, srs.w_host)) if blind else acc


def test_commit_matches_host_oracle():
    srs = tsrs.setup(4, device="cpu")
    rng = random.Random(7)
    cols = [[rng.randrange(P) for _ in range(16)] for _ in range(5)]
    cols[2] = [0] * 16  # the zero polynomial commits to the identity
    cols[3] = cols[3][:11]  # shorter than 2^k: zero-padded
    blinds = [0, rng.randrange(P), 0, 5, rng.randrange(P)]
    want = [_oracle(srs, c, b) for c, b in zip(cols, blinds)]
    enc = [FP.encode(c) for c in cols]
    # chunks of four columns (the last one alone, padded to four)
    assert commit_many(srs, enc, blinds=blinds, commit_chunk=4) == want
    assert want[2] is None
    assert commit(srs, enc[4], blind=blinds[4]) == want[4]


def test_open_verifies_and_tampering_fails():
    k = 3
    srs = tsrs.setup(k, device="cpu")
    n = 1 << k
    rng = random.Random(70 + k)
    coeffs = [rng.randrange(P) for _ in range(n)]
    x = rng.randrange(P)
    v = sum(c * pow(x, i, P) for i, c in enumerate(coeffs)) % P
    blind = rng.randrange(P)
    cm = commit(srs, FP.encode(coeffs), blind=blind)

    tw = TranscriptWriter()
    tw.common_point(cm)
    tw.common_scalar(x)
    tw.common_scalar(v)
    open_poly(srs, tw, FP.encode(coeffs), x, blind=blind, rng=SeededRng(k))
    proof = tw.finalize()

    def check(proof_bytes, value):
        tr = TranscriptReader(proof_bytes)
        tr.common_point(cm)
        tr.common_scalar(x)
        tr.common_scalar(value)
        return verify_open(srs, tr, cm, x, value) and tr.finished()

    assert check(proof, v)
    assert not check(proof, (v + 1) % P)
    raw = np.frombuffer(proof, np.uint8).copy()
    raw[-40] ^= 1  # inside a0: the final scalar check fails
    assert not check(raw.tobytes(), v)
