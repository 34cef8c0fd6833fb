"""A frozen copy of the port's `tinyram/selectors.py`.

Per-instruction selection vectors, Out bits, and changed bits.

This is the TPU-shaped replacement for the reference's
`TempVarSelectorsRow::from(&Instruction)` tables (aux.rs:105-397), the `Out`
tables (aux/out.rs:148-349) and `ChangedSelectors` (changed.rs) — one flat
numpy row per program line, consumed both by the Prog instance columns and
the batched Exe witness code.

Layout of one selector row (width = SEL_WIDTH(reg_count)):
  A: pc_next, reg[R], reg_next[R], a, v_addr, non_det              (2R+4)
  B: pc, pc_next, pc_plus_one, reg[R], reg_next[R], a, non_det,
     max_word                                                       (2R+6)
  C: reg[R], reg_next[R], a, non_det, zero                          (2R+3)
  D: pc_plus_one, reg[R], reg_next[R], a, non_det, zero, one        (2R+5)
  ch: reg[R], pc, flag                                              (R+2)
  out: and,xor,or,sum,ssum,prod,sprod,mod,shift,f1,f2,f3,f4         (13)
  shift_left                                                        (1)

Documented deviations from the reference (each strengthens soundness):
  * `SelectorsD` uses a dedicated `pc_plus_one` bit with a pc+1 routing
    gate.  The reference encodes SelectionD::PcPlusOne as pc AND one bits
    (aux.rs:1066-1070), whose two routing gates (d=pc, d=1) conflict for
    CJmp; nothing used D=Pc alone, so the column is repurposed.
  * LoadW gets `out = {xor}` and `B = RegN(ri)` so the loaded value is tied
    to the destination register (reference leaves LoadW's Out empty with a
    FIXME, aux/out.rs:333-338, and B=Reg(ri), aux.rs:366-376).
  * A `shift_left` bit (1 = Shl, 0 = Shr) joins the Out lookup so the
    shift-power key can depend soundly on direction; the reference's Shr
    path is unsound without it (d unchecked FIXME, exe/temp_vars.rs:108-115).
"""

from __future__ import annotations

import numpy as np

from .isa import Imm, Instruction, Reg

OUT_NAMES = [
    "and", "xor", "or", "sum", "ssum", "prod", "sprod", "mod",
    "shift", "flag1", "flag2", "flag3", "flag4",
]

# out bits per mnemonic — aux/out.rs:148-349 (LoadW fixed per module docstring)
OUT_BITS = {
    "And": {"and", "flag1", "flag2"},
    "Or": {"or", "flag1", "flag2"},
    "Xor": {"xor", "flag1", "flag2"},
    "Not": {"xor", "flag1", "flag2"},
    "Add": {"sum"},
    "Sub": {"sum"},
    "Mull": {"prod", "flag1", "flag2"},
    "UMulh": {"prod", "flag1", "flag2"},
    "SMulh": {"sprod", "flag1", "flag2"},
    "UDiv": {"mod", "flag1", "flag2", "flag3"},
    "UMod": {"mod", "flag1", "flag2", "flag3"},
    "Shl": {"shift", "flag4"},
    "Shr": {"shift", "flag4"},
    "Cmpe": {"xor", "flag1", "flag2"},
    "Cmpa": {"sum"},
    "Cmpae": {"sum"},
    "Cmpg": {"ssum"},
    "Cmpge": {"ssum"},
    "Mov": {"xor"},
    "CMov": {"mod"},
    "Jmp": {"xor"},
    "CJmp": {"mod"},
    "CnJmp": {"mod"},
    "LoadW": {"xor"},  # deviation: reference FIXME leaves this empty
    "StoreW": {"xor"},
    "Answer": set(),
}


def sel_layout(reg_count: int):
    """Ordered field names of one selector row."""
    R = reg_count
    names = []
    names += ["a.pc_next"] + [f"a.reg{f}" for f in range(R)] + [
        f"a.reg_next{f}" for f in range(R)
    ] + ["a.a", "a.v_addr", "a.non_det"]
    names += ["b.pc", "b.pc_next", "b.pc_plus_one"] + [
        f"b.reg{f}" for f in range(R)
    ] + [f"b.reg_next{f}" for f in range(R)] + ["b.a", "b.non_det", "b.max_word"]
    names += [f"c.reg{f}" for f in range(R)] + [
        f"c.reg_next{f}" for f in range(R)
    ] + ["c.a", "c.non_det", "c.zero"]
    names += ["d.pc_plus_one"] + [f"d.reg{f}" for f in range(R)] + [
        f"d.reg_next{f}" for f in range(R)
    ] + ["d.a", "d.non_det", "d.zero", "d.one"]
    names += [f"ch.reg{f}" for f in range(R)] + ["ch.pc", "ch.flag"]
    names += [f"out.{o}" for o in OUT_NAMES]
    names += ["shift_left"]
    return names


def sel_width(reg_count: int) -> int:
    return len(sel_layout(reg_count))


# abstract selections (mirror aux.rs SelectionA..D); resolved per instruction
def _a_bits(row, prefix, sel, reg_count):
    """Apply an A-style selection (kind, arg) to row dict."""
    kind, arg = sel
    if kind == "reg":
        row[f"{prefix}.reg{arg}"] = 1
    elif kind == "reg_next":
        row[f"{prefix}.reg_next{arg}"] = 1
    elif kind == "A":
        if isinstance(arg, Imm):
            row[f"{prefix}.a"] = 1
        else:
            row[f"{prefix}.reg{arg.index}"] = 1
    elif kind == "unset":
        pass
    else:
        row[f"{prefix}.{kind}"] = 1


def selection_table(inst: Instruction):
    """(selA, selB, selC, selD, ch_set) — aux.rs:115-397 verbatim (see
    module docstring for the three documented deviations)."""
    op, ri, rj, a = inst.op, inst.ri, inst.rj, inst.a
    A = lambda: ("A", a)
    Reg_ = lambda r: ("reg", r)
    RegN = lambda r: ("reg_next", r)
    tbl = {
        "And": (A(), Reg_(rj), RegN(ri), ("unset", 0), {ri, "flag"}),
        "Or": (A(), Reg_(rj), RegN(ri), ("unset", 0), {ri, "flag"}),
        "Xor": (A(), Reg_(rj), RegN(ri), ("unset", 0), {ri, "flag"}),
        "Not": (A(), ("max_word", 0), RegN(ri), ("unset", 0), {ri, "flag"}),
        "Add": (A(), Reg_(rj), RegN(ri), ("zero", 0), {ri, "flag"}),
        "Sub": (A(), RegN(ri), Reg_(rj), ("zero", 0), {ri, "flag"}),
        "Mull": (A(), Reg_(rj), ("non_det", 0), RegN(ri), {ri, "flag"}),
        "UMulh": (A(), Reg_(rj), RegN(ri), ("non_det", 0), {ri, "flag"}),
        "SMulh": (A(), Reg_(rj), RegN(ri), ("non_det", 0), {ri, "flag"}),
        "UDiv": (("non_det", 0), RegN(ri), A(), Reg_(rj), {ri, "flag"}),
        "UMod": (RegN(ri), ("non_det", 0), A(), Reg_(rj), {ri, "flag"}),
        "Shl": (A(), Reg_(rj), ("non_det", 0), RegN(ri), {ri, "flag"}),
        "Shr": (A(), Reg_(rj), RegN(ri), ("non_det", 0), {ri, "flag"}),
        "Cmpe": (A(), Reg_(ri), ("non_det", 0), ("unset", 0), {"flag"}),
        "Cmpa": (Reg_(ri), ("non_det", 0), A(), ("zero", 0), {"flag"}),
        "Cmpae": (Reg_(ri), ("non_det", 0), A(), ("one", 0), {"flag"}),
        "Cmpg": (Reg_(ri), ("non_det", 0), A(), ("zero", 0), {"flag"}),
        "Cmpge": (Reg_(ri), ("non_det", 0), A(), ("one", 0), {"flag"}),
        "Mov": (A(), RegN(ri), ("zero", 0), ("unset", 0), {ri}),
        "CMov": (RegN(ri), A(), ("zero", 0), Reg_(ri), {ri}),
        "Jmp": (A(), ("pc_next", 0), ("zero", 0), ("unset", 0), {"pc"}),
        "CJmp": (("pc_next", 0), A(), ("zero", 0), ("pc_plus_one", 0), {"pc"}),
        "CnJmp": (("pc_next", 0), ("pc_plus_one", 0), ("zero", 0), A(), {"pc"}),
        # d routes the address operand [A] so the Exe↔Mem link can bind the
        # memory address (deviation: reference leaves d = Zero and the
        # address entirely unconstrained, exe.rs address column unused)
        "LoadW": (("v_addr", 0), RegN(ri), ("zero", 0), A(), {ri}),
        "StoreW": (("v_addr", 0), RegN(ri), ("zero", 0), A(), set()),
        "Answer": (A(), ("pc", 0), ("zero", 0), ("zero", 0), set()),
    }
    return tbl[op]


def selector_row(inst: Instruction, reg_count: int) -> np.ndarray:
    """One flat 0/1 selector row for a program line."""
    names = sel_layout(reg_count)
    row = {k: 0 for k in names}
    sa, sb, sc, sd, ch = selection_table(inst)
    _a_bits(row, "a", sa, reg_count)
    _a_bits(row, "b", sb, reg_count)
    _a_bits(row, "c", sc, reg_count)
    _a_bits(row, "d", sd, reg_count)
    for c in ch:
        if c == "flag":
            row["ch.flag"] = 1
        elif c == "pc":
            row["ch.pc"] = 1
        else:
            row[f"ch.reg{c}"] = 1
    for o in OUT_BITS[inst.op]:
        row[f"out.{o}"] = 1
    if inst.op == "Shl":
        row["shift_left"] = 1
    return np.array([row[k] for k in names], dtype=np.int64)


def out_table_rows() -> np.ndarray:
    """The fixed OutTable: opcode+1 -> (continue, out bits, shift_left).

    Row layout: [opcode_plus_1, continue, *out_bits, shift_left, is_store,
    is_load]; includes the all-zero default row (out_table.rs:84-93,
    133-215 + the direction/memory indicator columns).
    """
    from .isa import OPCODES

    rows = []
    for op, code in OPCODES.items():
        cont = 0 if op == "Answer" else 1
        bits = [1 if o in OUT_BITS[op] else 0 for o in OUT_NAMES]
        left = 1 if op == "Shl" else 0
        st = 1 if op == "StoreW" else 0
        ld = 1 if op == "LoadW" else 0
        rows.append([code + 1, cont] + bits + [left, st, ld])
    rows.append([0] * (2 + len(OUT_NAMES) + 3))  # default row
    return np.array(rows, dtype=np.int64)
