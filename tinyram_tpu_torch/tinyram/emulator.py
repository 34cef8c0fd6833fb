"""TinyRAM emulator: executes a Program into a columnar Trace.

Semantics follow the reference `Program::eval` exactly
(reference/src/trace.rs:378-552), including every flag rule
(SURVEY.md §2 L1 "Emulator flag semantics worth preserving exactly") and the
Arya p.13 convention of pre-writing the input tapes into memory
(trace.rs:155-173).

Unlike the reference's Vec<Step>, the trace is **columnar numpy arrays** —
the shape the batched witness builder consumes directly (SURVEY.md §3.4:
convert row-at-a-time assignment into batched column construction).
A C++ fast path for multi-million-step traces lives in native/.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .isa import (
    ANSWER_OPCODE,
    Imm,
    Instruction,
    Program,
    decode_signed,
    truncate,
    word_mask,
)


@dataclass
class MemAccess:
    kind: str  # "init" | "store" | "load"
    address: int
    time: int  # 0 for init
    value: int


@dataclass
class Trace:
    word_bits: int
    reg_count: int
    prog: Program
    # step arrays, one entry per executed instruction (time 1..len)
    pc: np.ndarray  # (T,)
    opcode: np.ndarray  # (T,)
    regs: np.ndarray  # (T+1, R): regs[t] = register file BEFORE step t
    flag: np.ndarray  # (T+1,): flag[t] = flag BEFORE step t
    v_addr: np.ndarray  # (T,) memory value moved this step (0 if none)
    inst_index: np.ndarray  # (T,) index into prog of the executed instruction
    accesses: list[MemAccess] = field(default_factory=list)
    answer: int = 0
    # tape regions (public primary tape words / private aux tape length) —
    # consumed by the tape-binding instance columns (exe.py)
    primary_tape: tuple = ()
    aux_len: int = 0

    @property
    def primary_len(self) -> int:
        return len(self.primary_tape)

    def __len__(self):
        return len(self.pc)


def eval_program(
    prog: Program,
    word_bits: int,
    reg_count: int,
    primary_tape=(),
    aux_tape=(),
    max_steps: int | None = None,
) -> Trace:
    mask = word_mask(word_bits)
    w = word_bits
    # loud validation: an immediate beyond the word size would be masked
    # here but committed raw into the prog-table instance, yielding a
    # silently unsatisfiable witness (r4: a W=16 run of the W=24 config-2
    # program "failed to verify" with every constraint nonzero)
    for i, inst in enumerate(prog):
        if isinstance(inst.a, Imm) and not 0 <= inst.a.value <= mask:
            raise ValueError(
                f"program line {i} ({inst.op}): immediate "
                f"{inst.a.value:#x} does not fit word_bits={word_bits}"
            )
    regs = [0] * reg_count
    flag = False
    pc = 0
    time = 1

    # tapes pre-written to memory as Init accesses (trace.rs:157-173)
    assert word_bits % 8 == 0, "tape convention needs byte-aligned words"
    mem: dict[int, int] = {}
    accesses: list[MemAccess] = []
    for i, word in enumerate(list(primary_tape) + list(aux_tape)):
        addr = i * word_bits // 8
        mem[addr] = int(word)
        accesses.append(MemAccess("init", addr, 0, int(word)))

    pcs, opcodes, v_addrs, inst_idx = [], [], [], []
    regs_hist = [list(regs)]
    flag_hist = [flag]
    answer = None

    limit = max_steps if max_steps is not None else 1 << 62
    while len(pcs) < limit:
        assert pc < len(prog), "Program did not Answer."
        inst = prog[pc]
        a = inst.a_value(regs) & mask

        v_addr = 0
        if inst.op == "LoadW":
            addr = a
            if addr not in mem:
                mem[addr] = 0
                accesses.append(MemAccess("init", addr, 0, 0))
            v_addr = mem[addr]
            accesses.append(MemAccess("load", addr, time, v_addr))
        elif inst.op == "StoreW":
            addr = a
            val = regs[inst.ri]
            if addr not in mem:
                mem[addr] = 0
                accesses.append(MemAccess("init", addr, 0, 0))
            mem[addr] = val
            accesses.append(MemAccess("store", addr, time, val))
            v_addr = val

        pcs.append(pc)
        opcodes.append(inst.opcode)
        v_addrs.append(v_addr)
        inst_idx.append(pc)

        op = inst.op
        ri, rj = inst.ri, inst.rj
        if op in ("And", "Or", "Xor"):
            x = regs[rj]
            r = x & a if op == "And" else (x | a if op == "Or" else x ^ a)
            regs[ri] = r
            flag = r == 0
        elif op == "Not":
            regs[ri] = (~a) & mask
            flag = regs[ri] == 0
        elif op == "Add":
            r = regs[rj] + a
            regs[ri] = r & mask
            flag = r > mask
        elif op == "Sub":
            r = regs[rj] + (1 << w) - a
            regs[ri] = r & mask
            flag = (r >> w) == 0  # no carry-out ⇒ borrow (trace.rs:440-445)
        elif op == "Mull":
            r = regs[rj] * a
            regs[ri] = r & mask
            flag = r < (1 << w)  # (trace.rs:446-452)
        elif op == "UMulh":
            r = regs[rj] * a
            regs[ri] = (r >> w) & mask
            flag = regs[ri] == 0
        elif op == "SMulh":
            sa = decode_signed(a, w)
            sj = decode_signed(regs[rj], w)
            f = sa * sj
            regs[ri] = (f >> w) & mask
            flag = regs[ri] == 0
        elif op == "UDiv":
            regs[ri] = 0 if a == 0 else regs[rj] // a
            flag = a == 0
        elif op == "UMod":
            regs[ri] = 0 if a == 0 else regs[rj] % a
            flag = a == 0
        elif op == "Shl":
            x = regs[rj]
            regs[ri] = (x << a) & mask if a < 64 else 0
            flag = (x >> (w - 1)) & 1 == 1
        elif op == "Shr":
            x = regs[rj]
            regs[ri] = x >> a if a < 64 else 0
            flag = x & 1 == 1
        elif op == "Cmpe":
            flag = regs[ri] == a
        elif op == "Cmpa":
            flag = regs[ri] > a
        elif op == "Cmpae":
            flag = regs[ri] >= a
        elif op == "Cmpg":
            flag = decode_signed(regs[ri], w) > decode_signed(a, w)
        elif op == "Cmpge":
            flag = decode_signed(regs[ri], w) >= decode_signed(a, w)
        elif op == "Mov":
            regs[ri] = a
        elif op == "CMov":
            if flag:
                regs[ri] = a
        elif op == "LoadW":
            regs[ri] = v_addr
        elif op == "StoreW":
            pass
        elif op == "Answer":
            answer = a
        elif op in ("Jmp", "CJmp", "CnJmp"):
            pass
        else:  # pragma: no cover
            raise AssertionError(op)

        # pc update (trace.rs:514-543): jumps set pc; everything else +1
        if op == "Jmp":
            pc = a
        elif op == "CJmp":
            pc = a if flag else pc + 1
        elif op == "CnJmp":
            pc = pc + 1 if flag else a
        else:
            pc += 1

        regs_hist.append(list(regs))
        flag_hist.append(flag)
        time += 1
        if answer is not None:
            break

    assert answer is not None, "trace hit max_steps before Answer"
    return Trace(
        word_bits=word_bits,
        reg_count=reg_count,
        prog=prog,
        pc=np.array(pcs, dtype=np.int64),
        opcode=np.array(opcodes, dtype=np.int64),
        regs=np.array(regs_hist, dtype=np.int64),
        flag=np.array(flag_hist, dtype=np.int64),
        v_addr=np.array(v_addrs, dtype=np.int64),
        inst_index=np.array(inst_idx, dtype=np.int64),
        accesses=accesses,
        answer=answer,
        primary_tape=tuple(int(w) for w in primary_tape),
        aux_len=len(list(aux_tape)),
    )
