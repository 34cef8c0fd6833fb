"""Host Vesta linear combinations in Jacobian coordinates.

`curve/host.py` is the reference's affine oracle: each of its additions
inverts a field element by a 255-bit modular exponentiation, so one scalar
multiplication costs ~380 of them.  The prover and verifier make a few
hundred host scalar multiplications per proof (commitment blinds, the IPA's
L/R terms, the verifier's multiopen fold and final check), which made them
most of a GPU proof's wall time.  Here a point is (X, Y, Z) with
x = X/Z^2, y = Y/Z^3 (Z = 0 the identity), and a whole linear combination
costs one inversion.  Results are the same affine points as the oracle's.
"""

from __future__ import annotations

from ..field.params import Q_VESTA_BASE
from .host import AffinePoint

Q = Q_VESTA_BASE
_IDENTITY = (1, 1, 0)


def _double(p):
    """2p on y^2 = x^3 + 5 (a = 0)."""
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return _IDENTITY
    YY = Y * Y % Q
    S = 4 * X * YY % Q
    M = 3 * X * X % Q
    X3 = (M * M - 2 * S) % Q
    Y3 = (M * (S - X3) - 8 * YY * YY) % Q
    return X3, Y3, 2 * Y * Z % Q


def _add(p, q):
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
        return _double(p) if R == 0 else _IDENTITY
    HH = H * H % Q
    HHH = H * HH % Q
    V = U1 * HH % Q
    X3 = (R * R - HHH - 2 * V) % Q
    Y3 = (R * (V - X3) - S1 * HHH) % Q
    return X3, Y3, Z1 * Z2 * H % Q


def _lift(p: AffinePoint):
    return _IDENTITY if p is None else (p[0], p[1], 1)


def _scalar_mul(k: int, p: AffinePoint):
    """k·p for k >= 0, left to right double-and-add."""
    if p is None or k == 0:
        return _IDENTITY
    base = _lift(p)
    acc = _IDENTITY
    for bit in bin(k)[2:]:
        acc = _double(acc)
        if bit == "1":
            acc = _add(acc, base)
    return acc


def to_affine(p) -> AffinePoint:
    X, Y, Z = p
    if Z == 0:
        return None
    zi = pow(Z, Q - 2, Q)
    zi2 = zi * zi % Q
    return (X * zi2 % Q, Y * zi2 * zi % Q)


def lincomb(terms, base: AffinePoint = None) -> AffinePoint:
    """base + Σ k·P over (k, P) in terms (k >= 0, P affine or None)."""
    acc = _lift(base)
    for k, p in terms:
        acc = _add(acc, _scalar_mul(k, p))
    return to_affine(acc)


def scalar_mul(k: int, p: AffinePoint) -> AffinePoint:
    """k·p for k >= 0; equal to `host.scalar_mul(k, p)`."""
    return to_affine(_scalar_mul(k, p))
