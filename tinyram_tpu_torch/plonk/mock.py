"""Mock prover: constraint evaluation without cryptography.

Port of `tinyram_tpu/plonk/mock.py`.  Evaluates every gate on the full
witness columns on the assignment's device (kernel B1 for every multiply
on the card), checks lookups as multisets and copy constraints directly,
and reports per-gate per-row failures by name.  The `Failure` list equals
the JAX package's: the same kind, name and detail, in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field.field import FP
from .circuit import Assignment, ConstraintSystem
from .prover import _eval_exprs_on

EVAL_ELEMENTS = 1 << 25  # cap on gate polynomials × rows per batched pass


def _decode_cols_i64(cols: list[torch.Tensor]):
    """Decode a list of (16, n) Montgomery columns to one (B, n) int64
    array in a single from_mont and device fetch, or None if any value
    exceeds 62 bits (the caller falls back to per-value bigints)."""
    stack = FP.from_mont(torch.stack(cols, dim=1))  # (16, B, n)
    host = stack.cpu().numpy().astype(np.int64)
    if host[4:].any() or (host[3] >> 14).any():
        return None
    out = host[0]
    for i in range(1, 4):
        out |= host[i] << (16 * i)
    return out  # (B, n)


def _rows_member(rows: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Vectorized multiset membership of (u, k) int64 row tuples in a
    (t, k) table, via a void byte-view (np.isin sorts)."""
    r = np.ascontiguousarray(rows)
    t = np.ascontiguousarray(table)
    if t.shape[0] == 0:
        return np.zeros(r.shape[0], dtype=bool)
    void = np.dtype((np.void, r.dtype.itemsize * r.shape[1]))
    rv = r.view(void).ravel()
    tv = t.view(void).ravel()
    return np.isin(rv, tv)


@dataclass
class Failure:
    kind: str  # "gate" | "lookup" | "copy"
    name: str
    detail: str

    def __str__(self):
        return f"[{self.kind}] {self.name}: {self.detail}"


def _eval_exprs_lagrange(exprs, asg: Assignment, cache: dict | None = None):
    """Batched lagrange-domain evaluation (see prover._eval_exprs_on)."""

    def get_col(kind, index):
        base = getattr(asg, kind)[index]
        assert base is not None, f"unassigned {kind}[{index}]"
        return base

    return _eval_exprs_on(exprs, get_col, 1, cache)


def eval_gates_lagrange(cs: ConstraintSystem, asg: Assignment):
    """Evaluate every gate poly over all rows; yields (gate, poly_idx, evals).

    Expression batches are capped at ~2^25 total elements, so that a large
    circuit does not stack every gate's intermediates at once."""
    tagged = [
        (g, pi, poly) for g in cs.gates for pi, poly in enumerate(g.polys)
    ]
    chunk = max(1, EVAL_ELEMENTS // max(asg.n, 1))
    for lo in range(0, len(tagged), chunk):
        sub = tagged[lo : lo + chunk]
        outs = _eval_exprs_lagrange([t[2] for t in sub], asg)
        for (g, pi, _), out in zip(sub, outs):
            yield g, pi, out


class MockProver:
    def __init__(self, cs: ConstraintSystem, asg: Assignment):
        self.cs = cs
        self.asg = asg

    def verify(self) -> list[Failure]:
        failures: list[Failure] = []
        asg = self.asg
        n = asg.n
        asg.finalize()

        # gates
        for g, pi, evals in eval_gates_lagrange(self.cs, asg):
            nz = torch.logical_not(FP.is_zero(evals)).cpu().numpy()
            if nz.any():
                rows = np.nonzero(nz)[0][:8].tolist()
                failures.append(
                    Failure(
                        "gate",
                        f"{g.name}#{pi}",
                        f"nonzero at rows {rows}"
                        + ("…" if nz.sum() > 8 else ""),
                    )
                )

        # lookups: every (input expr tuple) row must appear in the table
        # multiset.  All expressions of a lookup evaluate in one batched
        # pass and decode in one device fetch; the tuple membership is a
        # vectorized sorted merge.  Values beyond 62 bits take the bigint
        # path.
        u = self.cs.usable_rows(n)
        for lk in self.cs.lookups:
            cache: dict = {}
            k_in = len(lk.inputs)
            devs = _eval_exprs_lagrange(list(lk.inputs) + list(lk.tables),
                                        asg, cache)
            fast = _decode_cols_i64(devs)
            if fast is not None:
                rows_in = fast[:k_in, :u].T  # (u, k)
                tb_rows = fast[k_in:, :].T   # (n, k): the table spans all
                # rows (selector-gated table exprs zero out the others)
                ok = _rows_member(rows_in, tb_rows)
                bad = np.nonzero(~ok)[0]
                if len(bad):
                    r0 = int(bad[0])
                    failures.append(
                        Failure(
                            "lookup",
                            lk.name,
                            f"input row {r0} = {tuple(rows_in[r0].tolist())}"
                            " not in table",
                        )
                    )
            else:
                in_vals = [FP.decode(d) for d in devs[:k_in]]
                tb_vals = [FP.decode(d) for d in devs[k_in:]]
                table = set(zip(*tb_vals)) if tb_vals else set()
                rows_iter = list(zip(*(col[:u] for col in in_vals)))
                for row, tup in enumerate(rows_iter):
                    if tup not in table:
                        failures.append(
                            Failure(
                                "lookup",
                                lk.name,
                                f"input row {row} = {tup} not in table",
                            )
                        )
                        break

        # range lookups (LogUp arguments): every input value on every
        # usable row must be a member of the table column's usable rows
        for rl in self.cs.range_lookups:
            cache = {}
            devs = _eval_exprs_lagrange([rl.table] + list(rl.inputs),
                                        asg, cache)
            fast = _decode_cols_i64(devs)
            if fast is not None:
                t_vals = fast[0, :u]
                for ei in range(len(rl.inputs)):
                    vals = fast[1 + ei, :u]
                    rows = np.nonzero(~np.isin(vals, t_vals))[0]
                    if len(rows):
                        r0 = int(rows[0])
                        failures.append(
                            Failure(
                                "lookup",
                                f"{rl.name}[{ei}]",
                                f"input row {r0} = {int(vals[r0])}"
                                " not in table",
                            )
                        )
            else:
                t_list = FP.decode(devs[0])[:u]
                t_set = set(t_list)
                for ei in range(len(rl.inputs)):
                    vals = FP.decode(devs[1 + ei])[:u]
                    rows = [r for r, v in enumerate(vals) if v not in t_set]
                    if len(rows):
                        r0 = int(rows[0])
                        failures.append(
                            Failure(
                                "lookup",
                                f"{rl.name}[{ei}]",
                                f"input row {r0} = {vals[r0]} not in table",
                            )
                        )

        # copy constraints
        for (a, ar), (b, br) in self.cs.copies:
            va = FP.decode(asg.get(a)[:, ar : ar + 1])[0]
            vb = FP.decode(asg.get(b)[:, br : br + 1])[0]
            if va != vb:
                failures.append(
                    Failure(
                        "copy",
                        f"{a.kind}[{a.index}]@{ar} = {b.kind}[{b.index}]@{br}",
                        f"{va} != {vb}",
                    )
                )

        return failures

    def assert_satisfied(self) -> None:
        failures = self.verify()
        if failures:
            msg = "\n".join(str(f) for f in failures[:20])
            raise AssertionError(f"mock prover found failures:\n{msg}")
