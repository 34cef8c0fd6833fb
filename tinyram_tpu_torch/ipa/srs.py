"""SRS (unstructured generator set) for the IPA polynomial commitment.

Port of `tinyram_tpu/ipa/srs.py`: the same try-and-increment hash-to-curve
from Blake2b(label ‖ index ‖ counter), so both packages derive identical
generators.  Generation is host-side.  Each generator depends on its index
alone, so the 2^k generators of a smaller k are the first 2^k of a larger
one: the process keeps the generators hashed so far and hashes only those
it lacks, in a pool of worker processes when they are many (k = 17 has
2^17 of them, each a square root mod q after a hash).  `setup` caches an SRS in
memory per (k, device) and, when given a `cache_dir`, on disk in the
reference's `srs_vesta_k{k}.npz` format.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from multiprocessing import get_context

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


ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.path.join(ROOT, "build", "cache")  # SRS and key files on disk
_G_LABEL = b"tinyram-tpu-srs-g"
_G_HOST: list = []  # the G generators hashed (or loaded) so far, by index
POOL_MIN = 1 << 12  # fewer new generators than this are hashed in-process
_POOL_CHUNK = 1 << 11  # generators per task of a pool worker


def _hash_range(lo: int, hi: int) -> list[AffinePoint]:
    return [_hash_to_curve(_G_LABEL, i) for i in range(lo, hi)]


def _workers() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def pool_map(fn, *iterables, workers: int | None = None) -> list:
    """[fn(*args) for args in zip(*iterables)] in a pool of `workers`
    (default: the usable cores) spawned processes, in order: the parent
    may hold a CUDA context, which a fork must not copy.  `fn` is a
    module-level function (workers import it by name)."""
    with ProcessPoolExecutor(workers or _workers(),
                             mp_context=get_context("spawn")) as ex:
        return list(ex.map(fn, *iterables))


def hash_generators(lo: int, hi: int, workers: int = 1) -> list[AffinePoint]:
    """G generators lo .. hi-1; with `workers` > 1 in a pool of that many
    spawned processes (`pool_map`), in index order."""
    if workers <= 1 or hi - lo <= _POOL_CHUNK:
        return _hash_range(lo, hi)
    starts = list(range(lo, hi, _POOL_CHUNK))
    ends = [min(s + _POOL_CHUNK, hi) for s in starts]
    return [pt for part in pool_map(_hash_range, starts, ends, workers=workers)
            for pt in part]


def _generators(n: int) -> list[AffinePoint]:
    """The first n G generators, hashing only those not hashed before."""
    have = len(_G_HOST)
    if n > have:
        workers = _workers() if n - have >= POOL_MIN else 1
        _G_HOST.extend(hash_generators(have, n, workers))
    return _G_HOST[:n]


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
        if len(_G_HOST) < n:
            _G_HOST[:] = pts[:n]
    else:
        pts = _generators(n) + [_hash_to_curve(b"tinyram-tpu-srs-u", 0),
                                _hash_to_curve(b"tinyram-tpu-srs-w", 0)]
        if path is not None:
            os.makedirs(cache_dir, exist_ok=True)
            xs = np.array([np.frombuffer(p[0].to_bytes(32, "little"), np.uint8)
                           for p in pts])
            ys = np.array([np.frombuffer(p[1].to_bytes(32, "little"), np.uint8)
                           for p in pts])
            tmp = f"{path}.tmp{os.getpid()}.npz"
            np.savez(tmp, xs=xs, ys=ys)
            os.replace(tmp, path)
    return pts[:n], pts[n], pts[n + 1]


def cache_generators(k: int, cache_dir: str = CACHE_DIR) -> str:
    """The path of the SRS of 2^k generators on disk in `cache_dir`,
    written (from the generators hashed so far, or hashed now) if it is
    missing: processes started later, such as the ranks of a mesh, load
    it instead of hashing."""
    path = os.path.join(cache_dir, f"srs_vesta_k{k}.npz")
    if not os.path.exists(path):
        _gen_host(k, cache_dir)
    return path


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
