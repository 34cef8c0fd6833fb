"""SRS (unstructured generator set) for the IPA polynomial commitment.

Port of `tinyram_tpu/ipa/srs.py`: the same try-and-increment hash-to-curve
from Blake2b(label ‖ index ‖ counter), so both packages derive identical
generators.  Generation is host-side; `setup` caches an SRS in memory per
(k, device) and, when given a `cache_dir`, on disk in the reference's
`srs_vesta_k{k}.npz` format.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np

from ..curve import PointBatch, from_affine_host
from ..curve.host import AffinePoint, is_on_curve
from ..field.params import CURVE_B, Q_VESTA_BASE
from ..transcript.transcript import _sqrt_mod
from ..utils.device import CUDA, resolve


def _hash_to_curve(label: bytes, index: int) -> AffinePoint:
    q = Q_VESTA_BASE
    ctr = 0
    while True:
        raw = hashlib.blake2b(
            label + index.to_bytes(8, "little") + ctr.to_bytes(8, "little"),
            digest_size=32,
            person=b"tinyram-srs-v1",
        ).digest()
        x = int.from_bytes(raw, "little") % q
        rhs = (x * x * x + CURVE_B) % q
        y = _sqrt_mod(rhs, q)
        if y is not None:
            y = min(y, q - y)  # canonical (even-ish) choice
            pt = (x, y)
            assert is_on_curve(pt)
            return pt
        ctr += 1


@dataclass
class SRS:
    """k, the 2^k G generators, and the two auxiliary generators U, W."""

    k: int
    g_host: list[AffinePoint]
    u_host: AffinePoint
    w_host: AffinePoint
    g: PointBatch  # device copy of g_host

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def device(self):
        return self.g.x.device


def _gen_host(k: int, cache_dir: str | None):
    n = 1 << k
    path = None if cache_dir is None else os.path.join(
        cache_dir, f"srs_vesta_k{k}.npz"
    )
    if path is not None and os.path.exists(path):
        data = np.load(path)
        xs, ys = data["xs"], data["ys"]
        pts = [
            (int.from_bytes(xs[i].tobytes(), "little"),
             int.from_bytes(ys[i].tobytes(), "little"))
            for i in range(n + 2)
        ]
    else:
        pts = [_hash_to_curve(b"tinyram-tpu-srs-g", i) for i in range(n)]
        pts.append(_hash_to_curve(b"tinyram-tpu-srs-u", 0))
        pts.append(_hash_to_curve(b"tinyram-tpu-srs-w", 0))
        if path is not None:
            os.makedirs(cache_dir, exist_ok=True)
            xs = np.array([np.frombuffer(p[0].to_bytes(32, "little"), np.uint8)
                           for p in pts])
            ys = np.array([np.frombuffer(p[1].to_bytes(32, "little"), np.uint8)
                           for p in pts])
            np.savez(path, xs=xs, ys=ys)
    return pts[:n], pts[n], pts[n + 1]


_SRS_CACHE: dict = {}


def setup(k: int, device=CUDA, cache_dir: str | None = None) -> SRS:
    """Build (or load) the SRS for circuits of size 2^k on `device`."""
    device = resolve(device)
    key = (k, str(device))
    if key not in _SRS_CACHE:
        g_host, u_host, w_host = _gen_host(k, cache_dir)
        _SRS_CACHE[key] = SRS(
            k=k, g_host=g_host, u_host=u_host, w_host=w_host,
            g=from_affine_host(g_host, device),
        )
    return _SRS_CACHE[key]
