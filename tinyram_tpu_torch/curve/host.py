"""Host-side (Python-int) Vesta curve arithmetic — correctness oracle.

The commitment curve is Vesta (`EqAffine` in the reference's proof harness,
reference/src/test_utils.rs:21): y² = x³ + 5 over Fq, scalar field Fp.
This module is exact affine arithmetic used by tests and by the (host)
verifier; the TPU path lives in vesta.py.
"""

from __future__ import annotations

from ..field.params import CURVE_B, Q_VESTA_BASE

Q = Q_VESTA_BASE

# Affine points are (x, y) tuples; None is the identity.
AffinePoint = tuple[int, int] | None


def is_on_curve(pt: AffinePoint) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - CURVE_B) % Q == 0


def add(p1: AffinePoint, p2: AffinePoint) -> AffinePoint:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        # doubling (a = 0)
        lam = (3 * x1 * x1) * pow(2 * y1, Q - 2, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, Q - 2, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def neg(p: AffinePoint) -> AffinePoint:
    if p is None:
        return None
    return (p[0], (-p[1]) % Q)


def scalar_mul(k: int, p: AffinePoint) -> AffinePoint:
    acc: AffinePoint = None
    while k:
        if k & 1:
            acc = add(acc, p)
        p = add(p, p)
        k >>= 1
    return acc


def msm(scalars: list[int], points: list[AffinePoint]) -> AffinePoint:
    acc: AffinePoint = None
    for s, p in zip(scalars, points):
        acc = add(acc, scalar_mul(s, p))
    return acc
