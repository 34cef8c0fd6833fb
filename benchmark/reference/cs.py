"""PLONKish constraint system: columns, gates, lookups, copy constraints.

A frozen copy of the port's `plonk/circuit.py` constraint system (without
its device-side `Assignment`), so that the benchmark's reference builds
the circuit it checks proofs against from its own code.
"""

from __future__ import annotations

from dataclasses import dataclass

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
