"""The work a proof needs by the algorithm, and the least time the card
could take for it: the numerators of the rooflines.

Counted from the circuit's sizes and the protocol's structure (the
reference's constraint system), never from the port's launches or
instructions, so a change of algorithm inside a kernel does not move it:

- every commitment is an MSM of 2^k points with full-width scalars: the
  instance, advice, permuted lookup, multiplicity, grand product, LogUp
  helper, quotient chunk and multiopen commitments; each IPA round j
  (of k) is two MSMs of 2^(k-j-1) points;
- every polynomial the prover commits from its values is interpolated by
  one NTT of 2^k; every polynomial of the constraint identity but the
  fixed ones (whose cosets a key can hold) is evaluated on the extended
  domain, one NTT of 2^k per coset; the quotient is interpolated back by
  one NTT of 2^k per coset.

The least time of an MSM of m points is that of the fewest point
additions of the bucket method at its best window c,
ceil(255 / c)·m + 2^c, at 5 field products each (batched affine
additions), the products at the card's combined integer rate: a 255-bit
product as 27 32-bit multiply-adds (Karatsuba over eight 32-bit limbs,
its additions free) on the IMAD pipe, or as 1,024 int8 multiply-adds on
the tensor cores, both pipes at once.  Its bytes (each point and scalar
read once) bound it far lower.  The least time of an NTT of m points is
the larger of its butterflies' products, (m/2)·log2(m), at that rate and
its bytes, each input and output element read or written once at 32 B,
at the card's memory bandwidth.
"""

from __future__ import annotations

import json
import math
import os

from .reference.protocol import queried_column_rotations

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")
FE_BYTES = 32  # one field element, or one affine coordinate
SCALAR_BITS = 255
PRODUCTS_PER_ADD = 5
IMAD_PER_PRODUCT = 27
INT8_OPS_PER_PRODUCT = 2 * 32 * 32  # multiply and add of 32 x 32 bytes


def peaks() -> dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def products_per_s(pk: dict) -> float:
    """255-bit field products per second over the IMAD pipe and the int8
    tensor cores together."""
    imad = pk["sm_count"] * pk["boost_clock_hz"] * pk["imad_per_sm_per_clock"]
    return imad / IMAD_PER_PRODUCT + pk["int8_tensor_ops_per_s"] / INT8_OPS_PER_PRODUCT


def msm_additions(m: int) -> int:
    """The fewest point additions of the bucket method for m points."""
    if m <= 1:
        return 0
    return min(math.ceil(SCALAR_BITS / c) * m + (1 << c) for c in range(1, 25))


def msm_seconds(m: int, pk: dict) -> float:
    """The least time of an MSM of m points."""
    ops = msm_additions(m) * PRODUCTS_PER_ADD / products_per_s(pk)
    data = m * 3 * FE_BYTES / pk["hbm_bytes_per_s"]
    return max(ops, data)


def ntt_seconds(m: int, pk: dict) -> float:
    """The least time of an NTT of m points."""
    ops = (m // 2) * int(math.log2(m)) / products_per_s(pk)
    data = 2 * m * FE_BYTES / pk["hbm_bytes_per_s"]
    return max(ops, data)


def _helpers(cs) -> int:
    """The columns the lookups add: A', S' and z per lookup; h_b, h_T, m and
    z per LogUp argument; z of the permutation."""
    return (3 * len(cs.lookups)
            + sum(len(rl.batches()) + 3 for rl in cs.range_lookups)
            + (1 if cs.permutation_columns() else 0))


def commitments(cs) -> int:
    """The prover's commitments of 2^k points a proof makes: the instance,
    advice and lookup columns, the quotient's chunks, the multiopen's Q."""
    return (cs.num_instance + cs.num_advice + _helpers(cs)
            + (1 << cs.extension_factor_log2()) + 1)


def proof_msm_seconds(cs, k: int, pk: dict) -> float:
    """The least time of one proof's MSMs."""
    n = 1 << k
    ipa = sum(2 * msm_seconds(n >> (j + 1), pk) for j in range(k))
    return commitments(cs) * msm_seconds(n, pk) + ipa


def proof_ntt_seconds(cs, k: int, pk: dict) -> float:
    """The least time of one proof's transforms."""
    n = 1 << k
    cosets = 1 << cs.extension_factor_log2()
    interpolated = cs.num_instance + cs.num_advice + _helpers(cs)
    extended = _helpers(cs) + sum(1 for kind, _ in queried_column_rotations(cs)
                                  if kind != "fixed")
    return (interpolated * ntt_seconds(n, pk)
            + (extended + 1) * cosets * ntt_seconds(n, pk))
