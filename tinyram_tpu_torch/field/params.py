"""Pasta field parameters (host-side Python integers).

The reference circuit field is Fp, the Pallas base field (= Vesta scalar
field); polynomial commitments are points on the Vesta curve, whose base field
is Fq (see reference/src/test_utils.rs:12-21 — `Params<EqAffine>` with
`EqAffine` = Vesta affine, and the circuit `Fp` imported from `pasta::Fp`).

Every derived constant here is recomputed from the primes at import time with
plain Python integers, so there is nothing to copy and nothing to get stale.

Limb layout (device side): a field element is 16 little-endian limbs of 16
bits each, stored one-per-``uint32``. Montgomery radix R = 2**256.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

# Pallas base field (circuit field).  255 bits, p ≡ 1 (mod 2^32).
P_PALLAS_BASE = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
# Vesta base field (coordinate field of the commitment curve).
Q_VESTA_BASE = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# Both curves are y^2 = x^3 + 5 (a = 0, b = 5).
CURVE_B = 5

N_LIMBS = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
MONT_BITS = N_LIMBS * LIMB_BITS  # 256
R = 1 << MONT_BITS

# Multiplicative generator of both pasta fields is 5 (verified in tests by
# checking 5^((m-1)/2) != 1 and the 2-adic order below).
GENERATOR = 5
TWO_ADICITY = 32


def int_to_limbs(x: int) -> list[int]:
    """Little-endian 16-bit limbs of a (<=256-bit) integer."""
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(N_LIMBS)]


def limbs_to_int(limbs) -> int:
    out = 0
    for i, limb in enumerate(limbs):
        out |= (int(limb) & LIMB_MASK) << (LIMB_BITS * i)
    return out


def ints_to_limb_array(values) -> np.ndarray:
    """`int_to_limbs` of many non-negative ints below 2^256, as one (16, N)
    int32 array: each value's bytes at C speed, not a Python loop over its
    16 limbs."""
    buf = b"".join(int(v).to_bytes(2 * N_LIMBS, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, N_LIMBS).T.astype(
        np.int32, order="C")


def limb_array_to_ints(limbs) -> list[int]:
    """`limbs_to_int` of each column of a (16, N) array of limbs below
    2^16."""
    buf = np.ascontiguousarray(np.asarray(limbs).T, dtype="<u2").tobytes()
    step = 2 * N_LIMBS
    return [int.from_bytes(buf[i:i + step], "little")
            for i in range(0, len(buf), step)]


@dataclass(frozen=True)
class FieldParams:
    """All host-side constants for one prime field."""

    name: str
    modulus: int
    # -modulus^{-1} mod 2^LIMB_BITS (Montgomery n0').
    n0_inv: int
    # R mod p, R^2 mod p (for to/from Montgomery form).
    r_mod_p: int
    r2_mod_p: int
    # 2-adic root of unity of maximal order 2^TWO_ADICITY, NOT in Montgomery form.
    root_of_unity: int
    generator: int
    two_adicity: int

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    def t_odd(self) -> int:
        """Odd part t of p - 1 = 2^two_adicity * t."""
        return (self.modulus - 1) >> self.two_adicity


def _make(name: str, modulus: int) -> FieldParams:
    n0_inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
    r_mod_p = R % modulus
    r2_mod_p = (R * R) % modulus
    t = (modulus - 1) >> TWO_ADICITY
    root = pow(GENERATOR, t, modulus)
    # sanity: root has exact order 2^TWO_ADICITY
    assert pow(root, 1 << (TWO_ADICITY - 1), modulus) == modulus - 1
    return FieldParams(
        name=name,
        modulus=modulus,
        n0_inv=n0_inv,
        r_mod_p=r_mod_p,
        r2_mod_p=r2_mod_p,
        root_of_unity=root,
        generator=GENERATOR,
        two_adicity=TWO_ADICITY,
    )


@lru_cache(maxsize=None)
def fp_params() -> FieldParams:
    """Circuit field Fp (Pallas base = Vesta scalar)."""
    return _make("Fp", P_PALLAS_BASE)


@lru_cache(maxsize=None)
def fq_params() -> FieldParams:
    """Curve coordinate field Fq (Vesta base = Pallas scalar)."""
    return _make("Fq", Q_VESTA_BASE)
