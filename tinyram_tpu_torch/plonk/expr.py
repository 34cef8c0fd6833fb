"""Polynomial expression IR for the PLONKish constraint system.

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


def _skeleton(e: Expr, vars_out: list):
    """Structural key of an expression; Var nodes become slot indices.

    Distinct Var occurrences (by first-visit order of distinct Var values)
    become slots; constants stay in the key so only truly identical
    structures batch together.
    """
    if isinstance(e, Const):
        return ("c", e.value)
    if isinstance(e, Var):
        try:
            idx = vars_out.index(e)
        except ValueError:
            idx = len(vars_out)
            vars_out.append(e)
        return ("v", idx, e.rotation)
    if isinstance(e, Sum):
        return ("+", _skeleton(e.a, vars_out), _skeleton(e.b, vars_out))
    if isinstance(e, Product):
        return ("*", _skeleton(e.a, vars_out), _skeleton(e.b, vars_out))
    if isinstance(e, Neg):
        return ("-", _skeleton(e.a, vars_out))
    raise TypeError(type(e))


def batched_evaluate(exprs, *, slot_value, const, add, mul, neg, stack):
    """Evaluate many expressions, batching structurally identical ones.

    ``slot_value(var) -> value`` resolves one Var; ``stack(values) -> batch``
    combines B same-slot values; arithmetic callbacks must broadcast over
    the stacked batch axis.  Returns a list of per-expression results, where
    each result is ``(group_result, index_in_group, group_size)`` — callers
    slice out their lane.
    """
    groups: dict = {}
    order = []
    for ei, e in enumerate(exprs):
        vars_list: list = []
        key = _skeleton(e, vars_list)
        groups.setdefault(key, []).append((ei, e, vars_list))
        order.append(key)

    results: dict[int, tuple] = {}
    for key, members in groups.items():
        _, e0, vars0 = members[0]
        n_slots = len(vars0)
        slot_stacks = []
        for s in range(n_slots):
            slot_stacks.append(stack([slot_value(m[2][s]) for m in members]))

        def var_cb(kind, index, rotation, _e0vars=vars0, _stacks=slot_stacks):
            from .expr import Var as _V

            v = _V(kind, index, rotation)
            return _stacks[_e0vars.index(v)]

        out = evaluate(
            e0, var=var_cb, const=const, add=add, mul=mul, neg=neg
        )
        for gi, (ei, _, _) in enumerate(members):
            results[ei] = (out, gi, len(members))
    return [results[i] for i in range(len(exprs))]
