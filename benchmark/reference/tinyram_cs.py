"""The TinyRAM Exe table's constraints, fixed and instance columns: a frozen
copy of the port's `tinyram/exe.py` without its witness code.

TPU-native reimplementation of the reference's `ExeConfig`/`ExeChip`
(reference/src/circuits/tables/exe.rs) plus every gadget it composes
(logic, sum, ssum, prod, sprod, mod, shift, flag1-4, signed, even-bits,
changed — SURVEY.md §2 L3/L4).  Constraint semantics follow the reference
gate-for-gate, with documented fixes (see selectors.py docstring and
inline notes) for the reference's known-incomplete spots:

  * Shr uses a sound two-table power encoding (a_power = 2^(W-s) exact),
    with the direction bits (shift_left/shift_right) bound to the opcode
    through the Out table — fixes exe/temp_vars.rs:108-115 FIXME.
  * d is range-checked on shift rows.
  * a_shift=1 additionally requires a ≥ W (reference allowed a malicious
    a_shift=1 on small shifts, zeroing the result).
  * lsb_b is actually constrained (via the spread-bits table) instead of
    being free advice (flag4.rs:74-96).
  * The trace must end with Answer (last_row · s_trace = 0) and the answer
    value is bound to a public instance column (exe.rs:146 TODO).
  * msb booleanness is enforced.

Witness assignment is one vectorized numpy pass over the step arrays —
the replacement for the row-at-a-time `assign_trace` (exe.rs:792-1081,
SURVEY.md §3.4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .cs import Column, ConstraintSystem
from .expr import Const, Expr
from .isa import ANSWER_OPCODE, Imm, Instruction, Program
from .selectors import (
    OUT_NAMES,
    out_table_rows,
    sel_layout,
    selection_table,
    selector_row,
)


def spread(x: int) -> int:
    """Bits of x moved to even positions (even_bits.rs:211-223)."""
    r, c = 0, 0
    while x:
        r |= (x & 1) << (2 * c)
        x >>= 1
        c += 1
    return r


def spread_np(x: np.ndarray, word_bits: int) -> np.ndarray:
    out = np.zeros_like(x)
    for i in range(word_bits):
        out |= ((x >> i) & 1) << (2 * i)
    return out


def decomp_even_odd(x: np.ndarray, word_bits: int):
    """word -> (even, odd) spread parts: x = even + 2*odd (even_bits.rs:246)."""
    even_mask = sum(1 << (2 * i) for i in range((word_bits + 1) // 2))
    e = x & even_mask
    o = (x & (even_mask << 1)) >> 1
    return e, o


@dataclass
class ExeColumns:
    """Name-indexed column handles (fixed/advice/instance)."""

    fixed: dict
    advice: dict
    instance: dict


class TinyRamCS:
    """Builds the full TinyRAM constraint system for (WORD_BITS, REG_COUNT)."""

    def __init__(self, word_bits: int, reg_count: int, k: int | None = None):
        self.word_bits = word_bits
        self.reg_count = reg_count
        # fixed-table extent (even-bits range table = 2^(W/2) rows;
        # prog-table capacity) — the reference additionally capped the
        # TRACE at this length (exe.rs:104-106).  We decouple: pass a
        # larger k to get more trace rows than 2^(W/2) (BASELINE configs
        # 3-5 need 2^16+-step traces).
        self.table_len = 1 << (word_bits // 2)
        default_k = 2 + word_bits // 2
        self.k = default_k if k is None else k
        assert self.k >= default_k, "need 2^(W/2) rows for the range table"
        if self.k > default_k:
            # the W-bit even-bits range checks on m_time_inc require time
            # deltas (< trace length < n) to fit in W bits
            assert word_bits >= self.k, (
                f"decoupled rows need 2^W >= n (W={word_bits}, k={self.k})"
            )
        self.n = 1 << self.k
        self.cs = ConstraintSystem()
        # zero-knowledge: reserve blinding rows (advice opened at ≤2 points
        # each; 6 leaves slack).  All gates/lookups are st-gated, so the
        # random rows live outside every constraint's support.
        self.cs.blinding_factors = 6
        # s_table extent: all usable rows except the last (gates read
        # next-row cells).  Trace/mem capacity = st_rows − 1 (a trailing
        # in-table row keeps the end-transition gates anchored).
        self.st_rows = self.cs.usable_rows(self.n) - 1
        self.pl_names = [
            s for s in sel_layout(reg_count)
            if not s.startswith("out.") and s != "shift_left"
        ]
        self._build_columns()
        self._build_gates()
        self._build_lookups()

    # ------------------------------------------------------------- columns

    def _build_columns(self):
        cs = self.cs
        R = self.reg_count
        f, a, i = {}, {}, {}
        for name in (
            "s_table", "first_line", "last_row", "s_prog", "pc_fixed",
            "prog_pc", "st_pad",
            "t_even",
            "pow_val", "pow_mod",          # 2^i mod 2^W, i ∈ [0, W]
            "pow_exact_val", "pow_exact",  # 2^i exact,   i ∈ [0, W]
            "ot_opcode", "ot_cont",
            *[f"ot_{o}" for o in OUT_NAMES],
            "ot_left", "ot_right", "ot_is_store", "ot_is_load",
        ):
            f[name] = cs.fixed_column(name)
        a["s_trace"] = cs.advice_column("s_trace")
        a["pc"] = cs.advice_column("pc")
        for r in range(R):
            a[f"reg{r}"] = cs.advice_column(f"reg{r}")
        a["flag"] = cs.advice_column("flag")
        a["value"] = cs.advice_column("value")
        a["opcode"] = cs.advice_column("opcode")
        a["immediate"] = cs.advice_column("immediate")
        for name in self.pl_names:
            a[f"pl.{name}"] = cs.advice_column(f"pl.{name}")
        for o in OUT_NAMES:
            a[f"out.{o}"] = cs.advice_column(f"out.{o}")
        a["shift_left"] = cs.advice_column("shift_left")
        a["shift_right"] = cs.advice_column("shift_right")
        for v in "abcd":
            a[f"tv_{v}"] = cs.advice_column(f"tv_{v}")
            a[f"tv_{v}_e"] = cs.advice_column(f"tv_{v}_e")
            a[f"tv_{v}_o"] = cs.advice_column(f"tv_{v}_o")
        for s in ("esum", "osum"):
            for suf in ("", "_e", "_o"):
                a[f"{s}{suf}"] = cs.advice_column(f"{s}{suf}")
        for v in "abc":
            a[f"msb_{v}"] = cs.advice_column(f"msb_{v}")
            a[f"sigma_{v}"] = cs.advice_column(f"sigma_{v}")
            for suf in ("", "_e", "_o"):
                a[f"chk_{v}{suf}"] = cs.advice_column(f"chk_{v}{suf}")
        a["a_flag"] = cs.advice_column("a_flag")
        for suf in ("", "_e", "_o"):
            a[f"r{suf}"] = cs.advice_column(f"r{suf}")
        a["a_shift"] = cs.advice_column("a_shift")
        a["a_power"] = cs.advice_column("a_power")
        a["pow_key"] = cs.advice_column("pow_key")
        a["lsb_b"] = cs.advice_column("lsb_b")
        a["q_lsb"] = cs.advice_column("q_lsb")
        # Exe↔Mem linking (our completion of the reference's unfinished
        # memory story — SURVEY.md §2 L4 "Mem standalone only")
        a["is_store"] = cs.advice_column("is_store")
        a["is_load"] = cs.advice_column("is_load")
        a["s_mem_g"] = cs.advice_column("s_mem_g")
        a["address"] = cs.advice_column("address")
        for nm in (
            "m_s_trace", "m_addr", "m_time", "m_init", "m_store", "m_load",
            "m_value", "m_s_rw",
            "m_addr_inc", "m_addr_inc_e", "m_addr_inc_o",
            "m_time_inc", "m_time_inc_e", "m_time_inc_o",
            "m_in_tape", "m_in_aux",
            # degree-1 product columns for the link/tape lookups (keep the
            # lookup identity at degree ≤ 5 so the extended domain is 4n,
            # not 8n): mm_* = m_s_rw·m_*, tm_* = m_in_tape·m_*,
            # au_addr = m_in_aux·m_addr — st-gated defining gates below,
            # zeroed on the st-gap row by the st_pad gates.
            "mm_addr", "mm_time", "mm_value", "mm_store",
            "tm_addr", "tm_value", "au_addr",
        ):
            a[nm] = cs.advice_column(nm)

        # instance: program lines + opcode/immediate + claimed answer
        i["p.opcode"] = cs.instance_column("p.opcode")
        i["p.immediate"] = cs.instance_column("p.immediate")
        for name in self.pl_names:
            i[f"p.{name}"] = cs.instance_column(f"p.{name}")
        i["answer"] = cs.instance_column("answer")
        # public tape binding: primary tape entries (act, addr, value) and
        # the aux-tape address region (aux_act, aux_addr).  Closes the
        # "prover forges initial memory" gap the reference never reached
        # (its Mem table is unlinked — SURVEY.md §0 "Maturity").
        for nm in ("t.act", "t.addr", "t.value", "t.aux_act", "t.aux_addr"):
            i[nm] = cs.instance_column(nm)
        self.col = ExeColumns(fixed=f, advice=a, instance=i)

    # --------------------------------------------------------------- gates

    def _build_gates(self):
        cs = self.cs
        W = self.word_bits
        R = self.reg_count
        f, a = self.col.fixed, self.col.advice
        st = f["s_table"].cur()
        tr = a["s_trace"].cur()
        tr_n = a["s_trace"].next()
        MAX = 1 << W

        def out(name) -> Expr:
            return a[f"out.{name}"].cur()

        # --- trace shape gates (exe.rs:147-193 + our last-row/answer fixes)
        fl = f["first_line"].cur()
        cs.gate(
            "start_trace",
            [fl * (Const(1) - tr), fl * a["pc"].cur(), fl * a["flag"].cur()]
            + [fl * a[f"reg{r}"].cur() for r in range(R)],
        )
        # s_trace is a boolean contiguous prefix (exe.rs:170-193 intent,
        # hardened): booleanness + no 0->1 restart close the trace-island
        # and scaled-selector attacks; the end transition additionally
        # pins the last trace row's opcode to Answer.  The former single
        # gate leaned on `opcode`, which is free advice on tr=0 rows.
        cs.gate(
            "contiguous_trace",
            [
                st * tr * (tr - Const(1)),
                st * (Const(1) - tr) * tr_n,
                st * tr * (Const(1) - tr_n)
                * (a["opcode"].cur() - ANSWER_OPCODE),
            ],
        )
        cs.gate("trace_ends", f["last_row"].cur() * tr)
        cs.gate(
            "answer_binding",
            st * tr * (Const(1) - tr_n)
            * (a["tv_a"].cur() - self.col.instance["answer"].cur()),
        )

        # --- temp-var routing gates (exe.rs:195-498)
        def routing(sel_col: Expr, tv: Expr, target: Expr, next_gated: bool):
            gate_sel = (st * tr_n) if next_gated else (st * tr)
            return gate_sel * sel_col * (target - tv)

        for v in "abcd":
            tv = a[f"tv_{v}"].cur()
            p = f"pl.{v}"
            routes = []
            if v == "a":
                routes = [
                    (f"{p}.pc_next", a["pc"].next(), True),
                    (f"{p}.a", a["immediate"].cur(), False),
                    (f"{p}.v_addr", a["value"].cur(), False),
                ]
            elif v == "b":
                routes = [
                    (f"{p}.pc", a["pc"].cur(), True),
                    (f"{p}.pc_next", a["pc"].next(), True),
                    (f"{p}.pc_plus_one", a["pc"].cur() + 1, True),
                    (f"{p}.a", a["immediate"].cur(), False),
                    (f"{p}.max_word", Const(MAX - 1), False),
                ]
            elif v == "c":
                routes = [
                    (f"{p}.a", a["immediate"].cur(), False),
                    (f"{p}.zero", Const(0), False),
                ]
            else:
                routes = [
                    (f"{p}.pc_plus_one", a["pc"].cur() + 1, True),
                    (f"{p}.a", a["immediate"].cur(), False),
                    (f"{p}.zero", Const(0), False),
                    (f"{p}.one", Const(1), False),
                ]
            for sel_name, target, next_gated in routes:
                cs.gate(
                    f"tv.{v}.{sel_name.split('.')[-1]}",
                    routing(a[sel_name].cur(), tv, target, next_gated),
                )
            for r in range(R):
                cs.gate(
                    f"tv.{v}.reg{r}",
                    routing(a[f"{p}.reg{r}"].cur(), tv, a[f"reg{r}"].cur(), False),
                )
                cs.gate(
                    f"tv.{v}.reg_next{r}",
                    routing(
                        a[f"{p}.reg_next{r}"].cur(), tv, a[f"reg{r}"].next(), True
                    ),
                )

        # --- unchanged gate (changed.rs:91-120)
        unchanged = [
            (Const(1) - a["pl.ch.pc"].cur())
            * (a["pc"].cur() + 1 - a["pc"].next()),
            (Const(1) - a["pl.ch.flag"].cur())
            * (a["flag"].cur() - a["flag"].next()),
        ] + [
            (Const(1) - a[f"pl.ch.reg{r}"].cur())
            * (a[f"reg{r}"].cur() - a[f"reg{r}"].next())
            for r in range(R)
        ]
        cs.gate("unchanged", [st * tr_n * u for u in unchanged])

        # --- even-bits decompose gates (even_bits.rs:146-156); activation
        # unions cover every gadget use (see temp_vars.rs:64-116 + fixes)
        self.eb_activations = {
            "tv_a": ["and", "or", "xor", "mod", "ssum", "sprod"],
            "tv_b": ["and", "or", "xor", "mod", "sum", "ssum", "sprod", "flag4"],
            "tv_c": ["xor", "prod", "shift", "ssum", "sprod"],
            "tv_d": ["prod", "sprod", "shift"],
            "esum": ["and", "or", "xor"],
            "osum": ["and", "or", "xor"],
            "chk_a": ["ssum", "sprod"],
            "chk_b": ["sprod", "flag4"],
            "chk_c": ["ssum", "sprod"],
            "r": ["flag3", "shift"],
        }

        def acts_expr(names) -> Expr:
            e = out(names[0])
            for nm in names[1:]:
                e = e + out(nm)
            return e

        for word, acts in self.eb_activations.items():
            sel = st * acts_expr(acts)
            cs.gate(
                f"decomp.{word}",
                sel
                * (a[f"{word}_e"].cur() + 2 * a[f"{word}_o"].cur()
                   - a[word].cur()),
            )

        # --- logic gadget (logic.rs:125-185)
        s_logic = st * (out("and") + out("xor") + out("or"))
        cs.gate(
            "l_add.even",
            s_logic * (a["tv_a_e"].cur() + a["tv_b_e"].cur() - a["esum"].cur()),
        )
        cs.gate(
            "l_add.odd",
            s_logic * (a["tv_a_o"].cur() + a["tv_b_o"].cur() - a["osum"].cur()),
        )
        and_expr = a["esum_o"].cur() + 2 * a["osum_o"].cur()
        xor_expr = a["esum_e"].cur() + 2 * a["osum_e"].cur()
        res = a["tv_c"].cur()
        cs.gate("and", st * out("and") * (and_expr - res))
        cs.gate("xor", st * out("xor") * (xor_expr - res))
        cs.gate("or", st * out("or") * (xor_expr + and_expr - res))

        # --- sum (sum.rs:78-96): a + b = c + 2^W·flag' − d
        tva, tvb, tvc, tvd = (a[f"tv_{v}"].cur() for v in "abcd")
        flag_n = a["flag"].next()
        cs.gate(
            "sum", st * out("sum") * (tva + tvb - tvc - Const(MAX) * flag_n + tvd)
        )

        # --- signed decomposition (signed.rs:79-106 + msb booleanness)
        for v in "abc":
            s_signed = st * acts_expr(self.eb_activations[f"chk_{v}"])
            msb = a[f"msb_{v}"].cur()
            sigma = a[f"sigma_{v}"].cur()
            word = a[f"tv_{v}"].cur()
            word_odd = a[f"tv_{v}_o"].cur()
            cs.gate(
                f"signed.{v}",
                [
                    s_signed * (word - msb * MAX
                                - (sigma - msb * 2 * sigma)),
                    s_signed * (word_odd + (Const(1) - 2 * msb)
                                * (1 << (W - 2)) - a[f"chk_{v}"].cur()),
                    s_signed * msb * (msb - 1),
                ],
            )

        def signed_val(v):  # word − msb·2^W (the signed value, degree 1)
            return a[f"tv_{v}"].cur() - a[f"msb_{v}"].cur() * MAX

        # --- ssum (ssum.rs:75-102, degree-reduced via signed_val)
        cs.gate(
            "ssum",
            st * out("ssum")
            * (signed_val("a") + tvb - signed_val("c")
               - Const(MAX) * flag_n + tvd),
        )
        # --- prod (prod.rs:62-76): a·b = d + 2^W·c
        cs.gate("prod", st * out("prod") * (tva * tvb - tvd - Const(MAX) * tvc))
        # --- sprod (sprod.rs:66-93, degree-reduced)
        cs.gate(
            "sprod",
            st * out("sprod")
            * (signed_val("a") * signed_val("b") - tvd
               - Const(MAX) * signed_val("c")),
        )
        # --- mod (modulo.rs:40-55): flag'(b−d) + d − b·c − a = 0
        cs.gate(
            "mod",
            st * out("mod") * (flag_n * (tvb - tvd) + tvd - tvb * tvc - tva),
        )

        # --- shift (shift.rs:112-165 + soundness fixes, module docstring)
        ash = a["a_shift"].cur()
        r_comp = 2 * a["r_o"].cur() + a["r_e"].cur()
        il = a["shift_left"].cur()
        ir = a["shift_right"].cur()
        key_fwd = tva + ash * (Const(W) - tva)  # a, or W on overshift
        cs.gate(
            "shift",
            [
                st * out("shift") * ash * (ash - 1),
                st * out("shift") * (Const(1) - ash) * (Const(W) - tva - r_comp),
                st * out("shift") * ash * (tva - Const(W) - r_comp),
                st * out("shift") * (a["a_power"].cur() * tvb - tvd
                                     - Const(MAX) * tvc),
                st * out("shift") * (a["pow_key"].cur()
                                     - il * key_fwd
                                     - ir * (Const(W) - key_fwd)),
            ],
        )
        # --- flag1..flag4 (flag1.rs:32-48, flag2.rs:40-60, flag3.rs:43-85,
        #     flag4.rs:40-63 with constrained lsb)
        cs.gate("flag1", st * out("flag1") * flag_n * tvc)
        cs.gate(
            "flag2", st * out("flag2") * ((flag_n + tvc) * a["a_flag"].cur() - 1)
        )
        cs.gate(
            "flag3",
            [
                st * out("flag3")
                * (tvb * flag_n
                   + (Const(1) - flag_n) * (tvc - tva - 1 - r_comp)),
                st * out("flag3") * tvc * ((tvc - tva - 1) - a["r"].cur()),
            ],
        )
        lsb = a["lsb_b"].cur()
        cs.gate(
            "flag4",
            [
                st * out("flag4")
                * (flag_n - il * a["msb_b"].cur() - ir * lsb),
                st * out("flag4") * lsb * (lsb - 1),
                st * out("flag4")
                * (a["tv_b_e"].cur() - lsb - 4 * a["q_lsb"].cur()),
            ],
        )

        # --- Exe↔Mem linking gates -------------------------------------
        # definition gates are st-gated so ZK blinding rows stay free; the
        # lookups below re-gate the selector products with st for the same
        # reason.
        smg = a["s_mem_g"].cur()
        cs.gate(
            "mem.gate_def",
            st * (smg - a["is_store"].cur() - a["is_load"].cur()),
        )
        # address = [A] operand, routed through temp var d on mem ops
        cs.gate(
            "mem.address", st * smg * (a["address"].cur() - a["tv_d"].cur())
        )
        # memory-consistency gates (mem.rs:107-154, corrected load rule —
        # see tinyram/mem.py docstring)
        m_tr_n = a["m_s_trace"].next()
        m_addr, m_addr_n = a["m_addr"].cur(), a["m_addr"].next()
        m_time, m_time_n = a["m_time"].cur(), a["m_time"].next()
        same_cycle = m_addr_n - m_addr
        end_cycle = m_addr_n - m_addr - Const(1) - a["m_addr_inc"].next()
        time_sorted = m_time_n - m_time - a["m_time_inc"].next()
        msel = st * m_tr_n
        cs.gate(
            "mem.table",
            [
                msel * end_cycle * same_cycle,
                msel * end_cycle * time_sorted,
                msel * end_cycle * a["m_init"].next(),
                msel * a["m_load"].next()
                * (a["m_value"].next() - a["m_value"].cur()),
            ],
        )
        cs.gate(
            "mem.rw_def",
            st * (a["m_s_rw"].cur()
                  - a["m_s_trace"].cur() * (Const(1) - a["m_init"].cur())),
        )
        # m_s_trace is a boolean contiguous prefix: forged "island" rows
        # after a gap would escape the global address-sort chain and admit
        # duplicate address cycles (forged loads).
        m_tr = a["m_s_trace"].cur()
        cs.gate(
            "mem.contig",
            [
                st * m_tr * (m_tr - 1),
                st * (Const(1) - m_tr) * a["m_s_trace"].next(),
            ],
        )
        for w in ("m_addr_inc", "m_time_inc"):
            cs.gate(
                f"decomp.{w}",
                st * a["m_s_trace"].cur()
                * (a[f"{w}_e"].cur() + 2 * a[f"{w}_o"].cur() - a[w].cur()),
            )
        # kind bits must be boolean and exactly one per active mem row
        cs.gate(
            "mem.kinds",
            [
                st * a["m_s_trace"].cur()
                * (a["m_init"].cur() + a["m_store"].cur() + a["m_load"].cur()
                   - Const(1)),
                st * a["m_init"].cur() * (a["m_init"].cur() - 1),
                st * a["m_store"].cur() * (a["m_store"].cur() - 1),
                st * a["m_load"].cur() * (a["m_load"].cur() - 1),
            ],
        )

        # --- tape binding gates: every init row is a primary-tape entry,
        # an aux-tape word (value free = nondeterministic input), or zero.
        # Membership itself is enforced by the tape lookups (_build_lookups).
        it, ia = a["m_in_tape"].cur(), a["m_in_aux"].cur()
        cs.gate(
            "tape.init",
            [
                st * it * (it - 1),
                st * ia * (ia - 1),
                st * it * ia,
                st * it * (Const(1) - a["m_init"].cur()),
                st * ia * (Const(1) - a["m_init"].cur()),
                # in-tape rows must be REAL mem-table rows, not phantoms
                st * it * (Const(1) - a["m_s_trace"].cur()),
                st * ia * (Const(1) - a["m_s_trace"].cur()),
                st * a["m_init"].cur() * (Const(1) - it - ia)
                * a["m_value"].cur(),
            ],
        )

        # --- lookup product columns: mm_* = m_s_rw·m_*, tm_* = it·m_*,
        # au_addr = ia·m_addr.  Defined on st rows; the st_pad gates pin
        # the gating bits and products to 0 on the single row between the
        # st extent and the ZK blinding region, so the degree-1 lookup
        # tuples below cannot be forged there.
        srw = a["m_s_rw"].cur()
        for dst, src in (
            ("mm_addr", a["m_addr"].cur()), ("mm_time", a["m_time"].cur()),
            ("mm_value", a["m_value"].cur()), ("mm_store", a["m_store"].cur()),
        ):
            cs.gate(f"def.{dst}", st * (a[dst].cur() - srw * src))
        cs.gate("def.tm_addr", st * (a["tm_addr"].cur() - it * a["m_addr"].cur()))
        cs.gate("def.tm_value",
                st * (a["tm_value"].cur() - it * a["m_value"].cur()))
        cs.gate("def.au_addr", st * (a["au_addr"].cur() - ia * a["m_addr"].cur()))
        pad = f["st_pad"].cur()
        cs.gate(
            "st_pad.zero",
            [
                pad * a[nm].cur()
                for nm in (
                    "mm_addr", "mm_time", "mm_value", "mm_store",
                    "tm_addr", "tm_value", "au_addr",
                    "m_s_rw", "m_in_tape", "m_in_aux",
                    "s_mem_g", "is_store", "is_load", "s_trace",
                )
            ],
        )

    # ------------------------------------------------------------- lookups

    def _build_lookups(self):
        """Lookup arguments, all with identity degree ≤ 5 (extension 4n).

        Degree discipline (round 2; the round-1 circuit reached degree 8
        through doubly-gated tuples, doubling the extended domain): input
        gating bits (out.*, shift_*, s_trace, s_mem_g, …) are pinned by
        the Out lookup / trace gates on every row where they matter, so
        the extra `st` factor is redundant for soundness — on rows where
        a gating bit is genuinely free advice, a forged activation only
        adds a vacuously-satisfiable membership constraint (the prover
        can always pick a value that IS in the table; it never removes a
        check from a real row).  Table sides with composite entries use
        dedicated degree-1 product columns (mm_*, tm_*, au_addr) with
        st-gated defining gates.
        """
        cs = self.cs
        f, a, inst = self.col.fixed, self.col.advice, self.col.instance
        tr = a["s_trace"].cur()

        def out(name):
            return a[f"out.{name}"].cur()

        def acts_expr(names):
            e = out(names[0])
            for nm in names[1:]:
                e = e + out(nm)
            return e

        # even-bits range checks (even_bits.rs:158-170) for every decomp
        # word — ONE LogUp argument instead of 21 plookups (round 3).
        # Inputs are UNGATED: each _e/_o column is decomp_even_odd of an
        # in-range word on every row (see exe_witness), so membership holds
        # on inactive rows too — strictly stronger than the gated form,
        # and degree-1 inputs keep the batched helper identity at degree 5.
        eb_inputs = []
        for word in self.eb_activations:
            for part in ("_e", "_o"):
                eb_inputs.append(a[f"{word}{part}"].cur())
        # lsb spread-rest check (our fix; see _build_gates flag4)
        eb_inputs.append(a["q_lsb"].cur())

        # pow lookups: Shl (mod table), Shr (exact table) — shift.rs:144-166
        for tag, table_val, table_pow in (
            ("left", "pow_val", "pow_mod"),
            ("right", "pow_exact_val", "pow_exact"),
        ):
            gate = a[f"shift_{tag}"].cur()
            cs.lookup(
                f"pow.{tag}",
                [
                    gate * a["pow_key"].cur(),
                    gate * a["a_power"].cur() + Const(1) - gate,
                ],
                [f[table_val].cur(), f[table_pow].cur()],
            )

        # Out lookup: opcode+1 -> out bits + continue + direction
        # (out_table.rs:33-74 plus the direction columns).  s_trace is
        # boolean and pinned on every in-table row (contiguous_trace), so
        # it gates alone.
        s = tr
        inputs = [s * a["s_trace"].next(), s * (a["opcode"].cur() + 1)]
        tables = [f["ot_cont"].cur(), f["ot_opcode"].cur()]
        for o in OUT_NAMES:
            inputs.append(s * a[f"out.{o}"].cur())
            tables.append(f[f"ot_{o}"].cur())
        inputs += [s * a["shift_left"].cur(), s * a["shift_right"].cur(),
                   s * a["is_store"].cur(), s * a["is_load"].cur()]
        tables += [f["ot_left"].cur(), f["ot_right"].cur(),
                   f["ot_is_store"].cur(), f["ot_is_load"].cur()]
        cs.lookup("out", inputs, tables)

        # mem increment range checks ride the same LogUp argument (the inc
        # decomp parts are valid spreads on every row; zero beyond the mem
        # extent)
        for w in ("m_addr_inc", "m_time_inc"):
            for part in ("_e", "_o"):
                eb_inputs.append(a[f"{w}{part}"].cur())
        cs.range_lookup("eb", eb_inputs, f["t_even"].cur())

        # Exe↔Mem two-way linking: the multiset of Exe memory-op tuples
        # (addr, time, value, is_store) equals the multiset of non-init Mem
        # rows.  Tuples are distinct (unique times), so mutual inclusion is
        # equality.  time on the Exe side is the fixed row index + 1.
        # Leading gate-bit tuple elements make inactive rows the all-zero
        # tuple on both sides; the mem side is the degree-1 product columns.
        smg = a["s_mem_g"].cur()
        exe_tuple = [
            smg,
            smg * a["address"].cur(),
            smg * (f["pc_fixed"].cur() + 1),
            smg * a["value"].cur(),
            smg * a["is_store"].cur(),
        ]
        mem_tuple = [
            a["m_s_rw"].cur(),
            a["mm_addr"].cur(),
            a["mm_time"].cur(),
            a["mm_value"].cur(),
            a["mm_store"].cur(),
        ]
        cs.lookup("exe_mem", exe_tuple, mem_tuple)
        cs.lookup("mem_exe", mem_tuple, exe_tuple)

        # Tape binding (two-way): every active primary-tape instance entry
        # appears as an in-tape init row, and every in-tape init row matches
        # a tape entry.  Init rows are unique per address (sorted cycles),
        # so mutual inclusion pins the initial memory exactly.  Aux rows
        # need only address membership — their values are the private tape.
        it, ia = a["m_in_tape"].cur(), a["m_in_aux"].cur()
        tape_side = [
            inst["t.act"].cur(),
            inst["t.act"].cur() * inst["t.addr"].cur(),
            inst["t.act"].cur() * inst["t.value"].cur(),
        ]
        mem_side = [it, a["tm_addr"].cur(), a["tm_value"].cur()]
        cs.lookup("tape_mem", tape_side, mem_side)
        cs.lookup("mem_tape", mem_side, tape_side)
        cs.lookup(
            "mem_aux",
            [ia, a["au_addr"].cur()],
            [
                inst["t.aux_act"].cur(),
                inst["t.aux_act"].cur() * inst["t.aux_addr"].cur(),
            ],
        )

        # Prog dynamic lookup (prog.rs:163-193): every trace row's
        # (pc, opcode, immediate, selectors) is a row of the program table,
        # whose table side lives directly in instance columns.  The table
        # is NOT sp-gated: instead sp itself is tuple element 0, so rows
        # beyond the prog extent form the all-zero tuple (prog_pc and the
        # instance columns are zero there) which only tr = 0 input rows
        # can match.
        sp = f["s_prog"].cur()
        inputs = [tr, tr * a["pc"].cur(), tr * a["opcode"].cur(),
                  tr * a["immediate"].cur()]
        tables = [sp, f["prog_pc"].cur(), inst["p.opcode"].cur(),
                  inst["p.immediate"].cur()]
        for name in self.pl_names:
            inputs.append(tr * a[f"pl.{name}"].cur())
            tables.append(inst[f"p.{name}"].cur())
        cs.lookup("prog", inputs, tables)


def fixed_columns(tr_cs: TinyRamCS) -> dict[str, np.ndarray]:
    """All fixed columns (tables + structural selectors) as length-n arrays."""
    W = tr_cs.word_bits
    n = tr_cs.n
    tl = tr_cs.table_len
    cols: dict[str, np.ndarray] = {}

    def zero():
        return np.zeros(n, dtype=np.int64)

    st_rows = tr_cs.st_rows
    u = tr_cs.cs.usable_rows(n)
    s_table = zero(); s_table[:st_rows] = 1
    first = zero(); first[0] = 1
    last = zero(); last[st_rows - 1] = 1
    s_prog = zero(); s_prog[:tl] = 1
    # the Exe time column (row + 1 on memory-op rows): spans every
    # in-table row
    pc_fixed = np.arange(n, dtype=np.int64)
    # prog-table key: zero beyond the prog extent so those rows form the
    # all-zero table tuple
    prog_pc = zero(); prog_pc[:tl] = np.arange(tl)
    # rows between the st extent and the ZK blinding region (st_pad gates
    # zero the lookup gating bits there)
    st_pad = zero(); st_pad[st_rows:u] = 1
    t_even = zero()
    t_even[:tl] = spread_np(np.arange(tl), W)
    pow_val = zero(); pow_mod = zero()
    pow_exact_val = zero(); pow_exact = zero()
    # pad power tables with copies of row (0, 1): an all-zero padding row
    # would admit a_power=0 at key 0, breaking shift soundness.
    pow_mod[:] = 1
    pow_exact[:] = 1
    for iv in range(W + 1):
        pow_val[iv] = iv
        pow_mod[iv] = (1 << iv) % (1 << W)
        pow_exact_val[iv] = iv
        pow_exact[iv] = 1 << iv
    ot = out_table_rows()  # (27, 18): [op+1, cont, *out, left, store, load]
    ot_cols = {}
    names = ["ot_opcode", "ot_cont"] + [f"ot_{o}" for o in OUT_NAMES] + [
        "ot_left", "ot_right", "ot_is_store", "ot_is_load"
    ]
    full = np.zeros((n, len(names)), dtype=np.int64)
    nb = len(OUT_NAMES)
    full[: ot.shape[0], 0] = ot[:, 0]
    full[: ot.shape[0], 1] = ot[:, 1]
    for j in range(nb):
        full[: ot.shape[0], 2 + j] = ot[:, 2 + j]
    full[: ot.shape[0], 2 + nb] = ot[:, 2 + nb]      # shift_left
    full[: ot.shape[0], 4 + nb] = ot[:, 3 + nb]      # is_store
    full[: ot.shape[0], 5 + nb] = ot[:, 4 + nb]      # is_load
    # shift_right: 1 only on the Shr row
    from .isa import OPCODES

    shr_row = list(OPCODES).index("Shr")
    full[shr_row, 3 + nb] = 1
    for j, nm in enumerate(names):
        ot_cols[nm] = full[:, j]

    cols.update(
        s_table=s_table, first_line=first, last_row=last, s_prog=s_prog,
        pc_fixed=pc_fixed, prog_pc=prog_pc, st_pad=st_pad,
        t_even=t_even, pow_val=pow_val, pow_mod=pow_mod,
        pow_exact_val=pow_exact_val, pow_exact=pow_exact, **ot_cols,
    )
    return cols


def instance_columns(
    tr_cs: TinyRamCS, prog: Program, answer: int,
    primary=(), aux_len: int = 0,
) -> dict[str, np.ndarray]:
    """Instance columns: padded program lines, claimed answer, public tape.

    Mirrors program_instance (prog.rs:38-60): pad by repeating the final
    Answer instruction to TABLE_LEN.  The primary tape words and the
    aux-tape address region are public (Arya p.13 tape convention).
    """
    n, tl = tr_cs.n, tr_cs.table_len
    assert prog and prog[-1].op == "Answer"
    assert len(prog) <= tl
    padded = list(prog) + [prog[-1]] * (tl - len(prog))
    R = tr_cs.reg_count
    sel_names = sel_layout(R)
    cols = {}
    cols["p.opcode"] = np.zeros(n, dtype=np.int64)
    cols["p.immediate"] = np.zeros(n, dtype=np.int64)
    for nm in tr_cs.pl_names:
        cols[f"p.{nm}"] = np.zeros(n, dtype=np.int64)
    for row, inst in enumerate(padded):
        cols["p.opcode"][row] = inst.opcode
        cols["p.immediate"][row] = inst.immediate()
        sr = selector_row(inst, R)
        for ci, nm in enumerate(sel_names):
            if nm in tr_cs.pl_names:
                cols[f"p.{nm}"][row] = sr[ci]
    cols["answer"] = np.full(n, answer, dtype=np.int64)
    primary = list(primary)
    assert len(primary) + aux_len <= tl - 1, "tapes too long for table"
    wb = tr_cs.word_bits // 8
    for nm in ("t.act", "t.addr", "t.value", "t.aux_act", "t.aux_addr"):
        cols[nm] = np.zeros(n, dtype=np.int64)
    for i, word in enumerate(primary):
        cols["t.act"][i] = 1
        cols["t.addr"][i] = i * wb
        cols["t.value"][i] = int(word)
    for j in range(aux_len):
        cols["t.aux_act"][j] = 1
        cols["t.aux_addr"][j] = (len(primary) + j) * wb
    return cols
