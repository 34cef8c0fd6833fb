"""Circuit layout / constraint-system introspection dumps.

Copy of `tinyram_tpu/plonk/layout.py` (host code): text and Graphviz
renderings of the column/gate/lookup structure for debugging and docs, the
counterpart of halo2's `dev-graph` feature (`CircuitLayout`,
`circuit_dot_graph`).
"""

from __future__ import annotations

from .circuit import ConstraintSystem
from .expr import Const, Expr, Neg, Product, Sum, Var


def expr_str(e: Expr, cs: ConstraintSystem | None = None) -> str:
    def name(v: Var) -> str:
        if cs is not None:
            names = {
                "fixed": cs.fixed_names,
                "advice": cs.advice_names,
                "instance": cs.instance_names,
            }[v.kind]
            base = names[v.index]
        else:
            base = f"{v.kind}{v.index}"
        rot = {0: "", 1: "[+1]", -1: "[-1]"}[v.rotation]
        return f"{base}{rot}"

    if isinstance(e, Const):
        return str(e.value) if e.value < 1 << 16 else hex(e.value)
    if isinstance(e, Var):
        return name(e)
    if isinstance(e, Sum):
        return f"({expr_str(e.a, cs)} + {expr_str(e.b, cs)})"
    if isinstance(e, Product):
        return f"{expr_str(e.a, cs)}*{expr_str(e.b, cs)}"
    if isinstance(e, Neg):
        return f"-{expr_str(e.a, cs)}"
    raise TypeError(type(e))


def layout_summary(cs: ConstraintSystem) -> str:
    """Human-readable constraint-system summary (column counts, gates,
    lookups, degrees)."""
    lines = [
        f"columns: {cs.num_fixed} fixed, {cs.num_advice} advice, "
        f"{cs.num_instance} instance",
        f"gates: {len(cs.gates)} "
        f"({sum(len(g.polys) for g in cs.gates)} constraints), "
        f"max degree {cs.max_gate_degree()}",
        f"lookups: {len(cs.lookups)}",
        f"copy constraints: {len(cs.copies)} "
        f"over {len(cs.permutation_columns())} columns",
        f"required degree: {cs.required_degree()} "
        f"(extension 2^{cs.extension_factor_log2()})",
        "",
    ]
    for g in cs.gates:
        for pi, p in enumerate(g.polys):
            lines.append(f"gate {g.name}#{pi} (deg {p.degree()}): "
                         f"{expr_str(p, cs)}")
    for lk in cs.lookups:
        lines.append(
            f"lookup {lk.name}: [{', '.join(expr_str(e, cs) for e in lk.inputs[:4])}"
            + (", …" if len(lk.inputs) > 4 else "")
            + f"] ⊆ [{', '.join(expr_str(e, cs) for e in lk.tables[:4])}"
            + (", …" if len(lk.tables) > 4 else "") + "]"
        )
    return "\n".join(lines)


def layout_dot(cs: ConstraintSystem) -> str:
    """Graphviz digraph: gates/lookups -> referenced columns."""
    from .expr import queried_vars

    out = ["digraph circuit {", "  rankdir=LR;", "  node [fontsize=9];"]
    for gi, g in enumerate(cs.gates):
        gid = f"g{gi}"
        out.append(f'  {gid} [label="{g.name}", shape=box];')
        for v in queried_vars(g.polys):
            cid = f"{v.kind}{v.index}"
            out.append(f'  {gid} -> {cid};')
    for li, lk in enumerate(cs.lookups):
        lid = f"lk{li}"
        out.append(f'  {lid} [label="{lk.name}", shape=diamond];')
        for v in queried_vars(lk.inputs + lk.tables):
            out.append(f'  {lid} -> {v.kind}{v.index};')
    out.append("}")
    return "\n".join(out)
