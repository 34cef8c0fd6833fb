"""PLONKish constraint system: columns, gates, lookups, copy constraints.

Port of `tinyram_tpu/plonk/circuit.py`: `ConstraintSystem` is unchanged;
`Assignment` stores torch tensors on an explicit device.

The columnar replacement for halo2's `ConstraintSystem`/`Circuit` trait as
used by the reference (circuits/mod.rs:27-76).  Key departures, by design:

  * No `Region`/`Layouter`/row-at-a-time assignment: witness assignment is
    array construction — an `Assignment` is a set of full-length column
    arrays (SURVEY.md §7 "What NOT to replicate").
  * Fixed-table lookups and the fork's dynamic-table lookups
    (`create_dynamic_table`/`lookup_dynamic`, tables/prog.rs:145-192) are
    one concept here: a `Lookup` whose input and table sides are arbitrary
    expression tuples.  A dynamic table is just a table side built from
    advice columns gated by a selector expression; table rows where the
    selector is 0 compress to the θ-independent value 0, so an inactive
    input row (also 0) always finds a match as long as at least one table
    row is inactive — asserted by the mock prover.
  * Instance columns are available directly in gates; instance↔advice
    equality can therefore be a gate, while general copy constraints go
    through the permutation argument as usual.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..field.field import FP
from ..field.params import N_LIMBS
from ..utils.device import CUDA, resolve
from .expr import ADVICE, FIXED, INSTANCE, Expr, Var


@dataclass(frozen=True)
class Column:
    kind: str
    index: int

    def cur(self) -> Var:
        return Var(self.kind, self.index, 0)

    def next(self) -> Var:
        return Var(self.kind, self.index, 1)

    def prev(self) -> Var:
        return Var(self.kind, self.index, -1)


@dataclass
class Gate:
    name: str
    polys: list[Expr]


@dataclass
class Lookup:
    name: str
    inputs: list[Expr]
    tables: list[Expr]


@dataclass
class RangeLookup:
    """A LogUp (log-derivative) membership argument: every `inputs[j]`
    value on every usable row must appear in the single-column `table`.

    Replaces k independent plookup arguments (k×(A',S',Z) commitments)
    with ceil(k/4) helper columns + one multiplicity column + one running
    sum — the Haböck log-derivative lookup:

        Σ_rows Σ_j 1/(β + f_j) = Σ_rows m_r/(β + t_r).

    Input expressions must be degree ≤ 1 (the batched helper identity
    h·Π_j(β+f_j) = Σ_j Π_{l≠j}(β+f_l) has degree 1 + Σ deg f_j ≤ 5).
    """

    name: str
    inputs: list[Expr]
    table: Expr

    BATCH = 4  # inputs per helper column (degree 1+4 = 5 identity)

    def batches(self) -> list[list[Expr]]:
        return [
            self.inputs[i : i + self.BATCH]
            for i in range(0, len(self.inputs), self.BATCH)
        ]


class ConstraintSystem:
    """Collects columns, gates, lookups and copy constraints."""

    def __init__(self):
        self.num_fixed = 0
        self.num_advice = 0
        self.num_instance = 0
        # zero-knowledge blinding rows: the last `blinding_factors + 1` rows
        # of the domain are reserved — advice gets random values there, the
        # lookup/permutation product rules deactivate, and row
        # `n - blinding_factors - 1` carries the l_last·(z²−z) end check
        # (the halo2 usable-rows discipline).  0 ⇒ no blinding rows, but the
        # constraint shape below is the same either way (l_last at row n−1).
        self.blinding_factors = 0
        self.gates: list[Gate] = []
        self.lookups: list[Lookup] = []
        self.range_lookups: list[RangeLookup] = []
        # copy constraints: ((col, row), (col, row)) pairs
        self.copies: list[tuple[tuple[Column, int], tuple[Column, int]]] = []
        self.fixed_names: list[str] = []
        self.advice_names: list[str] = []
        self.instance_names: list[str] = []

    # ------------------------------------------------------------ columns

    def fixed_column(self, name: str = "") -> Column:
        c = Column(FIXED, self.num_fixed)
        self.num_fixed += 1
        self.fixed_names.append(name or f"f{c.index}")
        return c

    def advice_column(self, name: str = "") -> Column:
        c = Column(ADVICE, self.num_advice)
        self.num_advice += 1
        self.advice_names.append(name or f"a{c.index}")
        return c

    def instance_column(self, name: str = "") -> Column:
        c = Column(INSTANCE, self.num_instance)
        self.num_instance += 1
        self.instance_names.append(name or f"i{c.index}")
        return c

    selector = fixed_column  # a selector is just a 0/1 fixed column

    # ------------------------------------------------------------- gates

    def gate(self, name: str, polys) -> None:
        if isinstance(polys, Expr):
            polys = [polys]
        self.gates.append(Gate(name, list(polys)))

    def lookup(self, name: str, inputs, tables) -> None:
        inputs = list(inputs)
        tables = list(tables)
        assert len(inputs) == len(tables)
        self.lookups.append(Lookup(name, inputs, tables))

    def range_lookup(self, name: str, inputs, table) -> None:
        """Register a LogUp membership argument (see RangeLookup)."""
        inputs = list(inputs)
        assert inputs
        for e in inputs:
            assert e.degree() <= 1, (
                f"range_lookup {name}: input degree {e.degree()} > 1"
            )
        self.range_lookups.append(RangeLookup(name, inputs, table))

    def copy(self, a: Column, a_row: int, b: Column, b_row: int) -> None:
        self.copies.append(((a, a_row), (b, b_row)))

    # ------------------------------------------------------------ degrees

    def permutation_columns(self) -> list[Column]:
        cols = []
        for (a, _), (b, _) in self.copies:
            for c in (a, b):
                if c not in cols:
                    cols.append(c)
        return cols

    def max_gate_degree(self) -> int:
        d = 1
        for g in self.gates:
            for p in g.polys:
                d = max(d, p.degree())
        return d

    def required_degree(self) -> int:
        """Max degree over gates, lookup identities, permutation identity."""
        d = max(self.max_gate_degree(), 3)
        for lk in self.lookups:
            in_deg = max((e.degree() for e in lk.inputs), default=1)
            tb_deg = max((e.degree() for e in lk.tables), default=1)
            # active(X) · (Z(ωX)(A'+β)(S'+γ) − Z(X)(A+β)(S+γ))
            d = max(d, 2 + in_deg + tb_deg, 3)
        for rl in self.range_lookups:
            # h·Π_j(β+f_j) − Σ_j Π_{l≠j}(β+f_l), ungated
            d = max(d, 1 + sum(e.degree() for e in rl.batches()[0]))
            # h_T·(β+t) − m
            d = max(d, 1 + rl.table.degree())
        nperm = len(self.permutation_columns())
        if nperm:
            # active(X) · Z · Π (v + β δ^j X + γ)
            d = max(d, 1 + nperm + 2)
        return d

    def usable_rows(self, n: int) -> int:
        """u = n − (blinding_factors + 1).  Rows [0, u) carry real data and
        the product rules; row u is the l_last end-check row; rows (u, n)
        are pure blinding rows (random advice/Z values)."""
        return n - self.blinding_factors - 1

    def extension_factor_log2(self) -> int:
        d = self.required_degree()
        # quotient degree ≤ n(d-1) - n + ... ; n(d-1) evals needed
        return max(1, (d - 2).bit_length())


class Assignment:
    """Column arrays for one circuit instance.

    Arrays are (16, n) int32 limb tensors in Montgomery form on `device`.
    Helpers accept numpy int arrays (values mod p) and encode them.
    """

    def __init__(self, cs: ConstraintSystem, n: int, device=CUDA):
        self.cs = cs
        self.n = n
        self.device = resolve(device)
        self.fixed: list[Optional[torch.Tensor]] = [None] * cs.num_fixed
        self.advice: list[Optional[torch.Tensor]] = [None] * cs.num_advice
        self.instance: list[Optional[torch.Tensor]] = [None] * cs.num_instance

    def _encode(self, values) -> torch.Tensor:
        arr = np.asarray(values)
        assert arr.shape == (self.n,), f"expected ({self.n},), got {arr.shape}"
        if arr.dtype == object:  # python ints (may exceed 64 bits)
            return FP.encode([int(v) for v in arr], device=self.device)
        return FP.encode(arr, device=self.device)  # vectorized int64 path

    def set(self, col: Column, values) -> None:
        """Assign a full column from ints (host) or a (16, n) limb array."""
        if isinstance(values, (torch.Tensor, np.ndarray)) and values.ndim == 2:
            arr = torch.as_tensor(values, device=self.device)
            assert tuple(arr.shape) == (N_LIMBS, self.n)
        else:
            arr = self._encode(values)
        getattr(self, col.kind)[col.index] = arr

    def get(self, col: Column) -> torch.Tensor:
        v = getattr(self, col.kind)[col.index]
        assert v is not None, f"column {col} unassigned"
        return v

    def finalize(self) -> None:
        """Zero-fill any unassigned column."""
        for lst in (self.fixed, self.advice, self.instance):
            for i, v in enumerate(lst):
                if v is None:
                    lst[i] = FP.zeros((self.n,), self.device)
