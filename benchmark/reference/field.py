"""The Pasta fields in Python integers: the circuit field Fp (Pallas base =
Vesta scalar) and the commitment curve's coordinate field Fq, their roots
of unity, and the transforms the reference needs between a column's
values on the domain and its coefficients."""

from __future__ import annotations

P_PALLAS_BASE = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
Q_VESTA_BASE = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
CURVE_B = 5  # both curves are y^2 = x^3 + 5
GENERATOR = 5  # a multiplicative generator of both fields
TWO_ADICITY = 32

P = P_PALLAS_BASE


def omega(k: int) -> int:
    """The generator of the 2^k-th roots of unity in Fp."""
    root = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
    return pow(root, 1 << (TWO_ADICITY - k), P)


def inv(x: int) -> int:
    return pow(x % P, P - 2, P)


def batch_inverse(vals: list[int]) -> list[int]:
    """[v^-1 mod p for v in vals] (all nonzero) by Montgomery's trick."""
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % P
    acc = inv(prefix[-1])
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * acc % P
        acc = acc * vals[i] % P
    return out


def ntt(values: list[int], root: int) -> list[int]:
    """y_j = sum_i values_i * root^(ij) for a power-of-two length
    (iterative radix 2, Python integers)."""
    n = len(values)
    a = [v % P for v in values]
    j = 0
    for i in range(1, n):  # bit-reversal permutation
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(root, n // length, P)
        half = length // 2
        ws = [1] * half
        for i in range(1, half):
            ws[i] = ws[i - 1] * w_len % P
        for start in range(0, n, length):
            for i in range(half):
                u = a[start + i]
                v = a[start + i + half] * ws[i] % P
                a[start + i] = (u + v) % P
                a[start + i + half] = (u - v) % P
        length <<= 1
    return a


def lagrange_to_coeff(values: list[int], k: int) -> list[int]:
    """The coefficients of the polynomial of degree < 2^k that takes
    `values[i]` at omega(k)^i."""
    n = 1 << k
    assert len(values) == n
    n_inv = inv(n)
    return [c * n_inv % P for c in ntt(values, inv(omega(k)))]
