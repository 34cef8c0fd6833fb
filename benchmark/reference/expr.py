"""A frozen copy of the port's `plonk/expr.py` (its batching left out).

Polynomial expression IR for the PLONKish constraint system.

Replaces halo2's `Expression` tree (used by every gadget `configure` in the
reference, e.g. reference/src/circuits/sum.rs:78-96).  Differences by
design:

  * Rotations are limited to {-1, 0, +1} — the reference only ever uses
    cur/next (SURVEY.md §5 long-context note), and the lookup argument needs
    prev; restricting rotations keeps multi-chip halo exchange to one row.
  * The fork's `SelectorExpression` marker (tables/mod.rs:42-53) is
    unnecessary here: combined selectors are just products, and our
    evaluators treat them uniformly.
  * One expression tree serves four evaluators: device Lagrange arrays (mock
    prover), device extended-coset arrays (quotient), host ints at a point
    (verifier), and degree computation (domain sizing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


class Expr:
    def __add__(self, other):
        return Sum(self, _lift(other))

    def __radd__(self, other):
        return Sum(_lift(other), self)

    def __sub__(self, other):
        return Sum(self, Neg(_lift(other)))

    def __rsub__(self, other):
        return Sum(_lift(other), Neg(self))

    def __mul__(self, other):
        return Product(self, _lift(other))

    def __rmul__(self, other):
        return Product(_lift(other), self)

    def __neg__(self):
        return Neg(self)

    def degree(self) -> int:
        raise NotImplementedError

    def children(self):
        return ()


def _lift(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, int):
        return Const(x)
    raise TypeError(f"cannot lift {type(x)} into Expr")


@dataclass(frozen=True)
class Const(Expr):
    value: int

    def degree(self) -> int:
        return 0


# column kinds
FIXED = "fixed"
ADVICE = "advice"
INSTANCE = "instance"


@dataclass(frozen=True)
class Var(Expr):
    """A (column kind, column index, rotation) query."""

    kind: str
    index: int
    rotation: int = 0

    def __post_init__(self):
        assert self.rotation in (-1, 0, 1), "only prev/cur/next rotations"

    def degree(self) -> int:
        return 1


@dataclass(frozen=True)
class Sum(Expr):
    a: Expr
    b: Expr

    def degree(self) -> int:
        return max(self.a.degree(), self.b.degree())

    def children(self):
        return (self.a, self.b)


@dataclass(frozen=True)
class Product(Expr):
    a: Expr
    b: Expr

    def degree(self) -> int:
        return self.a.degree() + self.b.degree()

    def children(self):
        return (self.a, self.b)


@dataclass(frozen=True)
class Neg(Expr):
    a: Expr

    def degree(self) -> int:
        return self.a.degree()

    def children(self):
        return (self.a,)


def evaluate(
    expr: Expr,
    *,
    var: Callable[[str, int, int], Any],
    const: Callable[[int], Any],
    add: Callable[[Any, Any], Any],
    mul: Callable[[Any, Any], Any],
    neg: Callable[[Any], Any],
    _cache: dict | None = None,
) -> Any:
    """Generic bottom-up evaluation with node-level memoization."""
    cache: dict = {} if _cache is None else _cache

    def rec(e: Expr):
        key = id(e)
        if key in cache:
            return cache[key]
        if isinstance(e, Const):
            out = const(e.value)
        elif isinstance(e, Var):
            out = var(e.kind, e.index, e.rotation)
        elif isinstance(e, Sum):
            out = add(rec(e.a), rec(e.b))
        elif isinstance(e, Product):
            out = mul(rec(e.a), rec(e.b))
        elif isinstance(e, Neg):
            out = neg(rec(e.a))
        else:
            raise TypeError(f"unknown expr node {type(e)}")
        cache[key] = out
        return out

    try:
        return rec(expr)
    finally:
        # rec refers to itself through its closure: without this the cycle
        # keeps every memoized node (whole evaluation columns) alive until
        # the garbage collector runs
        del rec


def queried_vars(exprs) -> set[Var]:
    """All distinct Var queries in a collection of expressions."""
    out: set[Var] = set()

    def walk(e: Expr):
        if isinstance(e, Var):
            out.add(e)
        for c in e.children():
            walk(c)

    for e in exprs:
        walk(e)
    return out


# ---------------------------------------------------------------- batching


