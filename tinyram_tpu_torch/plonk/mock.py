"""Mock prover: constraint evaluation without cryptography.

Port of `tinyram_tpu/plonk/mock.py`.  Evaluates every gate on the full
witness columns on the assignment's device (kernel B1 for every multiply
on the card), checks lookups as multisets and copy constraints directly,
and reports per-gate per-row failures by name.  The `Failure` list equals
the JAX package's: the same kind, name and detail, in the same order.

Every pass is cut to at most `EVAL_ELEMENTS` expression values: the gate
check into passes of polynomials over all rows (as the JAX mock does),
the lookup and LogUp checks into row slices, each of which evaluates a
lookup's expressions on its rows only (a rotation reads across the
slice's edge, wrapping around the column as `torch.roll` does) and is
decoded into host int64 before the membership merge over all rows.  A
column stored on the host (`Assignment(host=True)`) comes to the device
for the pass or slice that reads it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..field.field import FP
from .circuit import Assignment, ConstraintSystem
from .prover import _eval_exprs_on

EVAL_ELEMENTS = 1 << 25  # cap on expression values (× rows) per pass


def _decode_cols_i64(cols: list[torch.Tensor]):
    """Decode a list of (16, n) Montgomery columns to one (B, n) int64
    array in a single from_mont and device fetch, or None if any value
    exceeds 62 bits (the caller falls back to per-value bigints).  The
    limbs are joined on the device, so 8 bytes an element cross."""
    stack = FP.from_mont(torch.stack(cols, dim=1))  # (16, B, n)
    if bool(stack[4:].any()) or bool((stack[3] >> 14).any()):
        return None
    s64 = stack[:4].to(torch.int64)
    out = s64[0] | (s64[1] << 16) | (s64[2] << 32) | (s64[3] << 48)
    return out.cpu().numpy()  # (B, n)


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


class _RowSlice:
    """The roll of `_eval_exprs_on` for one row slice [lo, hi): rows
    lo + shift … hi − 1 + shift of the whole (stored) column, wrapping
    around its n rows as `torch.roll` does, on `device`."""

    def __init__(self, lo: int, hi: int, n: int, device):
        self.lo, self.rows, self.n, self.device = lo, hi - lo, n, device

    def __call__(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        a = (self.lo + shift) % self.n
        if a + self.rows <= self.n:
            part = x[:, a : a + self.rows]
        else:
            part = torch.cat([x[:, a:], x[:, : a + self.rows - self.n]],
                             dim=-1)
        return part.to(self.device).contiguous()


def _decode_sliced(exprs, asg: Assignment, rows: int) -> np.ndarray:
    """(len(exprs), rows) values of the expressions on rows [0, rows),
    evaluated and decoded in slices of at most EVAL_ELEMENTS values: int64,
    or Python ints (an object array) when a value exceeds 62 bits."""
    step = max(1, EVAL_ELEMENTS // max(len(exprs), 1))

    def get_col(kind, index):  # the stored column (host or device)
        col = getattr(asg, kind)[index]
        assert col is not None, f"unassigned {kind}[{index}]"
        return col

    parts = []
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        devs = _eval_exprs_on(exprs, get_col, 1, {},
                              _RowSlice(lo, hi, asg.n, asg.device))
        fast = _decode_cols_i64(devs)
        parts.append(fast if fast is not None else np.array(
            [FP.decode(c) for c in devs], dtype=object))
        del devs
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)


@dataclass
class Failure:
    kind: str  # "gate" | "lookup" | "copy"
    name: str
    detail: str

    def __str__(self):
        return f"[{self.kind}] {self.name}: {self.detail}"


def _eval_exprs_lagrange(exprs, asg: Assignment, cache: dict | None = None):
    """Batched lagrange-domain evaluation (see prover._eval_exprs_on); each
    column read comes to the device once a call (`Assignment.fetch`)."""
    fetched: dict = {}

    def get_col(kind, index):
        if (kind, index) not in fetched:
            fetched[(kind, index)] = asg.fetch(kind, index)
        return fetched[(kind, index)]

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
        # multiset.  A lookup's expressions evaluate in row slices, each
        # batched and decoded in one device fetch; the tuple membership is
        # a vectorized sorted merge over all rows.  Values beyond 62 bits
        # take the bigint path.
        u = self.cs.usable_rows(n)
        for lk in self.cs.lookups:
            k_in = len(lk.inputs)
            vals = _decode_sliced(list(lk.inputs) + list(lk.tables), asg, n)
            rows_in = vals[:k_in, :u].T  # (u, k)
            tb_rows = vals[k_in:, :].T   # (n, k): the table spans all rows
            # (selector-gated table exprs zero out the others)
            if vals.dtype != object:
                bad = np.nonzero(~_rows_member(rows_in, tb_rows))[0]
            else:
                table = set(map(tuple, tb_rows.tolist()))
                bad = [r for r, tup in enumerate(map(tuple, rows_in.tolist()))
                       if tup not in table][:1]
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
            del vals, rows_in, tb_rows

        # range lookups (LogUp arguments): every input value on every
        # usable row must be a member of the table column's usable rows
        for rl in self.cs.range_lookups:
            vals = _decode_sliced([rl.table] + list(rl.inputs), asg, u)
            t_vals = vals[0]
            t_set = set(t_vals.tolist()) if vals.dtype == object else None
            for ei in range(len(rl.inputs)):
                col = vals[1 + ei]
                if t_set is None:
                    rows = np.nonzero(~np.isin(col, t_vals))[0]
                else:
                    rows = [r for r, v in enumerate(col.tolist())
                            if v not in t_set][:1]
                if len(rows):
                    r0 = int(rows[0])
                    failures.append(
                        Failure(
                            "lookup",
                            f"{rl.name}[{ei}]",
                            f"input row {r0} = {int(col[r0])} not in table",
                        )
                    )
            del vals

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
