"""Shared prover/verifier protocol schedule (a frozen copy of the port's
`plonk/protocol.py`).

Both sides must enumerate commitments, challenges, evaluations and opening
claims in exactly the same canonical order; this module is that single
source of truth.  (In halo2 this ordering is implicit in create_proof /
verify_proof code structure; making it an explicit data structure is what
lets the two sides here stay in lock-step.)

Transcript layout (v1):

  vk commitments → instance commitments → advice commitments → θ →
  per-lookup (A' commit, S' commit) → per-range-lookup m commit → β, γ →
  z_perm commit → per-lookup z commit → per-range-lookup (h_0…h_{B-1},
  h_T, z) commits → y → quotient chunk commits → x →
  evaluations (schedule below) → multiopen (v, u, Q commit, z*, P_j(z*)…,
  s, IPA proof).

Evaluation schedule: for each queried (kind, col, rot) of advice and fixed
columns (sorted), then σ_j (rot 0), z_perm (rot 0, +1), per lookup A'
(rot 0, −1), S' (rot 0), z_lk (rot 0, +1), quotient chunks (rot 0).
Instance polynomials are never opened: the verifier knows them and
evaluates directly.
"""

from __future__ import annotations

from dataclasses import dataclass

from .cs import ConstraintSystem
from .expr import ADVICE, FIXED, INSTANCE, queried_vars

# poly ids are tuples: ("advice", i) ("fixed", i) ("sigma", j)
# ("zperm",) ("la", l) ("ls", l) ("lz", l) ("q", c)


def queried_column_rotations(cs: ConstraintSystem):
    """{(kind, index) -> sorted rotations} over gates + lookup expressions."""
    exprs = []
    for g in cs.gates:
        exprs.extend(g.polys)
    for lk in cs.lookups:
        exprs.extend(lk.inputs)
        exprs.extend(lk.tables)
    for rl in cs.range_lookups:
        exprs.extend(rl.inputs)
        exprs.append(rl.table)
    out: dict[tuple[str, int], set[int]] = {}
    for v in queried_vars(exprs):
        out.setdefault((v.kind, v.index), set()).add(v.rotation)
    # permutation columns need their rot-0 value in the identity check
    for col in cs.permutation_columns():
        out.setdefault((col.kind, col.index), set()).add(0)
    return {key: sorted(rots) for key, rots in out.items()}


@dataclass(frozen=True)
class EvalSlot:
    pid: tuple
    rotation: int  # -1 / 0 / +1 — evaluation point is x·ω^rotation
    opened: bool  # False for instance polys (verifier computes directly)


def eval_schedule(cs: ConstraintSystem, n_sigma: int, n_chunks: int):
    """Canonical ordered list of evaluation slots."""
    qcr = queried_column_rotations(cs)
    slots: list[EvalSlot] = []
    for kind in (ADVICE, FIXED, INSTANCE):
        count = {
            ADVICE: cs.num_advice,
            FIXED: cs.num_fixed,
            INSTANCE: cs.num_instance,
        }[kind]
        for i in range(count):
            for rot in qcr.get((kind, i), []):
                slots.append(
                    EvalSlot((kind, i), rot, opened=(kind != INSTANCE))
                )
    for j in range(n_sigma):
        slots.append(EvalSlot(("sigma", j), 0, True))
    if n_sigma:
        slots.append(EvalSlot(("zperm",), 0, True))
        slots.append(EvalSlot(("zperm",), 1, True))
    for li in range(len(cs.lookups)):
        slots.append(EvalSlot(("la", li), 0, True))
        slots.append(EvalSlot(("la", li), -1, True))
        slots.append(EvalSlot(("ls", li), 0, True))
        slots.append(EvalSlot(("lz", li), 0, True))
        slots.append(EvalSlot(("lz", li), 1, True))
    for ri, rl in enumerate(cs.range_lookups):
        for b in range(len(rl.batches())):
            slots.append(EvalSlot(("rh", ri, b), 0, True))
        slots.append(EvalSlot(("rt", ri), 0, True))
        slots.append(EvalSlot(("rm", ri), 0, True))
        slots.append(EvalSlot(("rz", ri), 0, True))
        slots.append(EvalSlot(("rz", ri), 1, True))
    for c in range(n_chunks):
        slots.append(EvalSlot(("q", c), 0, True))
    return slots


def multiopen_point_order(slots) -> list[int]:
    """Rotations that actually occur, in canonical order [0, +1, -1]."""
    present = {s.rotation for s in slots if s.opened}
    return [r for r in (0, 1, -1) if r in present]
