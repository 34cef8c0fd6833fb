"""The Vesta curve in Python integers: Jacobian arithmetic, a Pippenger
MSM whose windows can run in a pool of processes, and the SRS generators
hashed to the curve.

The point formulas and the hash to the curve are those of the port's
host code (`curve/host_jacobian.py`, `ipa/srs.py`), copied so that the
reference derives the generators itself.  A point is affine (x, y) or
None (the identity); Jacobian (X, Y, Z) stands for (X/Z^2, Y/Z^3), Z = 0
the identity.
"""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from .field import CURVE_B, Q_VESTA_BASE
from .transcript import _sqrt_mod

Q = Q_VESTA_BASE
IDENTITY = (1, 1, 0)
SCALAR_BITS = 255


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - CURVE_B) % Q == 0


def double(p):
    """2p on y^2 = x^3 + 5 (a = 0)."""
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return IDENTITY
    YY = Y * Y % Q
    S = 4 * X * YY % Q
    M = 3 * X * X % Q
    X3 = (M * M - 2 * S) % Q
    Y3 = (M * (S - X3) - 8 * YY * YY) % Q
    return X3, Y3, 2 * Y * Z % Q


def add(p, q):
    """p + q, complete: identities, doubling and p = -q handled."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    H = (U2 - U1) % Q
    R = (S2 - S1) % Q
    if H == 0:
        return double(p) if R == 0 else IDENTITY
    HH = H * H % Q
    HHH = H * HH % Q
    V = U1 * HH % Q
    X3 = (R * R - HHH - 2 * V) % Q
    Y3 = (R * (V - X3) - S1 * HHH) % Q
    return X3, Y3, Z1 * Z2 * H % Q


def add_affine(p, x2: int, y2: int):
    """p (Jacobian) + (x2, y2) (affine, not the identity)."""
    X1, Y1, Z1 = p
    if Z1 == 0:
        return x2, y2, 1
    Z1Z1 = Z1 * Z1 % Q
    U2 = x2 * Z1Z1 % Q
    S2 = y2 * Z1 * Z1Z1 % Q
    H = (U2 - X1) % Q
    R = (S2 - Y1) % Q
    if H == 0:
        return double(p) if R == 0 else IDENTITY
    HH = H * H % Q
    HHH = H * HH % Q
    V = X1 * HH % Q
    X3 = (R * R - HHH - 2 * V) % Q
    Y3 = (R * (V - X3) - Y1 * HHH) % Q
    return X3, Y3, Z1 * H % Q


def lift(pt):
    return IDENTITY if pt is None else (pt[0], pt[1], 1)


def to_affine(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zi = pow(Z, Q - 2, Q)
    zi2 = zi * zi % Q
    return X * zi2 % Q, Y * zi2 * zi % Q


def scalar_mul(k: int, pt):
    """k·pt (Jacobian) for k >= 0, left to right double-and-add."""
    if pt is None or k == 0:
        return IDENTITY
    acc = IDENTITY
    for bit in bin(k)[2:]:
        acc = double(acc)
        if bit == "1":
            acc = add_affine(acc, *pt)
    return acc


def lincomb(terms, base=None):
    """base + sum k·P over (k, P) in terms (k >= 0, P affine or None),
    affine."""
    acc = lift(base)
    for k, pt in terms:
        acc = add(acc, scalar_mul(k, pt))
    return to_affine(acc)


# ------------------------------------------------------------- MSM

_POOL_POINTS: list = []


def _set_points(points: list) -> None:
    _POOL_POINTS[:] = points


def _window_sum(digits: np.ndarray, c: int, points=None):
    """sum_i digits[i]·points[i] for digits below 2^c: the bucket method
    (Jacobian)."""
    points = _POOL_POINTS if points is None else points
    buckets = [IDENTITY] * (1 << c)
    for i in np.flatnonzero(digits).tolist():
        d = int(digits[i])
        x, y = points[i]
        buckets[d] = add_affine(buckets[d], x, y)
    acc = running = IDENTITY
    for d in range((1 << c) - 1, 0, -1):
        running = add(running, buckets[d])
        acc = add(acc, running)
    return acc


def _digits(scalars: list[int], c: int) -> list[np.ndarray]:
    """The base-2^c digits of each scalar, one array per window (lowest
    first)."""
    raw = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(-1, 32),
                         axis=1, bitorder="little").astype(np.int64)
    weights = 1 << np.arange(c, dtype=np.int64)
    return [bits[:, lo:lo + c] @ weights[:min(c, 256 - lo)]
            for lo in range(0, SCALAR_BITS, c)]


def msm(scalars: list[int], points: list, workers: int = 1):
    """sum scalars[i]·points[i] (affine), scalars in [0, 2^255); with
    `workers` > 1 the windows are summed in a pool of that many spawned
    processes."""
    keep = [(int(s), p) for s, p in zip(scalars, points)
            if s and p is not None]
    if not keep:
        return None
    scalars = [s for s, _ in keep]
    points = [p for _, p in keep]
    n = len(points)
    c = max(4, min(16, n.bit_length() - 3))
    windows = _digits(scalars, c)
    if workers > 1 and n >= 1 << 12:
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn"),
                                 initializer=_set_points,
                                 initargs=(points,)) as ex:
            sums = list(ex.map(_window_sum, windows, [c] * len(windows)))
    else:
        sums = [_window_sum(d, c, points) for d in windows]
    acc = IDENTITY
    for s in reversed(sums):
        for _ in range(c):
            acc = double(acc)
        acc = add(acc, s)
    return to_affine(acc)


def workers() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


# ------------------------------------------------------------- SRS

_G_LABEL = b"tinyram-tpu-srs-g"
_POOL_CHUNK = 1 << 11


def hash_to_curve(label: bytes, index: int):
    """Try-and-increment from Blake2b(label ‖ index ‖ counter)."""
    ctr = 0
    while True:
        raw = hashlib.blake2b(
            label + index.to_bytes(8, "little") + ctr.to_bytes(8, "little"),
            digest_size=32, person=b"tinyram-srs-v1").digest()
        x = int.from_bytes(raw, "little") % Q
        y = _sqrt_mod((x * x * x + CURVE_B) % Q, Q)
        if y is not None:
            pt = (x, min(y, Q - y))
            assert is_on_curve(pt)
            return pt
        ctr += 1


def _hash_range(lo: int, hi: int) -> list:
    return [hash_to_curve(_G_LABEL, i) for i in range(lo, hi)]


def _encode(points: list) -> np.ndarray:
    return np.frombuffer(b"".join(x.to_bytes(32, "little")
                                  + y.to_bytes(32, "little")
                                  for x, y in points), np.uint8)


def _decode(raw: np.ndarray) -> list:
    b = raw.tobytes()
    return [(int.from_bytes(b[i:i + 32], "little"),
             int.from_bytes(b[i + 32:i + 64], "little"))
            for i in range(0, len(b), 64)]


def srs(k: int, cache_dir: str | None = None, pool: int = 1):
    """(G, U, W): the 2^k generators and the two auxiliary ones; hashed in
    a pool of `pool` spawned processes when there are many, and kept in
    `cache_dir` (when given) with a digest of their bytes."""
    n = 1 << k
    path = None if cache_dir is None else os.path.join(
        cache_dir, f"reference_srs_k{k}.npz")
    if path is not None and os.path.exists(path):
        data = np.load(path)
        raw = data["points"]
        if hashlib.sha256(raw.tobytes()).hexdigest() == str(data["sha256"]):
            pts = _decode(raw)
            return pts[:n], pts[n], pts[n + 1]
    if pool > 1 and n > _POOL_CHUNK:
        starts = list(range(0, n, _POOL_CHUNK))
        ends = [min(s + _POOL_CHUNK, n) for s in starts]
        with ProcessPoolExecutor(pool, mp_context=get_context("spawn")) as ex:
            g = [p for part in ex.map(_hash_range, starts, ends) for p in part]
    else:
        g = _hash_range(0, n)
    u = hash_to_curve(b"tinyram-tpu-srs-u", 0)
    w = hash_to_curve(b"tinyram-tpu-srs-w", 0)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        raw = _encode(g + [u, w])
        tmp = f"{path}.tmp.npz"
        np.savez(tmp, points=raw, sha256=hashlib.sha256(raw.tobytes()).hexdigest())
        os.replace(tmp, path)
    return g, u, w
