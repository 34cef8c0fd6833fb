"""BASELINE.md benchmark programs (configs 2-3).

Config 2: arithmetic/bitwise mix, ~2^12 steps, W = 24 (k = 14).
Config 3: full ISA incl. load/store + shifts, ~2^16 steps, at either word:
W = 24 (k = 17; the benchmark's `benchmark/configs/config3.json`, its cells
`config3-prove` and `config3-short`) or its stated W = 32 (k = 18, which
the 2^16-row range and program tables force; `config3w32.json`, the cell
`config3w32-prove`).  The benchmark draws its immediates per program
(`benchmark/programs.py`); the programs here fix them.

Programs are small loops (the prog table caps program LENGTH at 2^(W/2)
lines; trace length is bounded by the row count — decoupled from the word
size in round 2, exe.py TinyRamCS).
"""

from __future__ import annotations

from .isa import Imm, Instruction, Reg


def _i(op, ri=None, rj=None, a=0, areg=None):
    return Instruction(op, ri, rj, Reg(areg) if areg is not None else Imm(a))


def config2_program(steps: int = 1 << 12, word_bits: int = 24) -> list:
    """Arithmetic/bitwise mix: a loop whose body touches Add/Sub/Mull/
    UMulh/SMulh/UDiv/UMod/And/Or/Xor/Not/Shl/Shr/compares (~19 steps per
    iteration), sized to execute ~``steps`` instructions.

    ``word_bits`` masks the immediates so the same program shape is
    satisfiable at any word size (r4: the raw 24-bit constants made W=16
    smoke runs silently unsatisfiable)."""
    mask = (1 << word_bits) - 1

    def m(v):
        return v & mask

    body = [
        _i("Add", ri=1, rj=1, a=m(0x9E3779)),
        _i("Sub", ri=2, rj=1, areg=3),
        _i("Mull", ri=3, rj=2, a=m(0x85EBCA)),
        _i("UMulh", ri=4, rj=3, areg=1),
        _i("SMulh", ri=5, rj=4, a=m(0xC2B2AE)),
        _i("UDiv", ri=6, rj=3, a=7),
        _i("UMod", ri=7, rj=3, a=11),
        _i("And", ri=4, rj=4, areg=2),
        _i("Or", ri=5, rj=5, areg=3),
        _i("Xor", ri=6, rj=6, areg=5),
        _i("Not", ri=7, areg=6),
        _i("Shl", ri=2, rj=6, a=3),
        _i("Shr", ri=3, rj=5, a=5),
        _i("Cmpa", ri=4, areg=5),
        _i("CMov", ri=5, a=m(0x1234)),
        _i("Cmpg", ri=6, areg=7),
    ]
    # loop control: r0 counts down
    iters = max(1, (steps - 2) // (len(body) + 3))
    prog = [_i("Mov", ri=0, a=iters)]
    loop_start = len(prog)
    prog += body
    prog += [
        _i("Sub", ri=0, rj=0, a=1),
        _i("Cmpe", ri=0, a=0),
        _i("CnJmp", a=loop_start),
        _i("Answer", areg=3),
    ]
    return prog


def config3_program(steps: int = 1 << 16, word_bits: int = 32) -> list:
    """Full-ISA mix incl. LoadW/StoreW and jumps (BASELINE config 3).

    ``word_bits`` masks the immediates so the same program shape runs at
    W = 24 (the round-3 2^16-step proof target) or W = 32."""
    mask = (1 << word_bits) - 1

    def m(v):
        return v & mask

    body = [
        _i("StoreW", ri=1, a=64),
        _i("LoadW", ri=2, a=64),
        _i("Add", ri=1, rj=2, a=m(0x9E3779B9)),
        _i("Mull", ri=3, rj=1, a=m(0x85EBCA6B)),
        _i("StoreW", ri=3, a=128),
        _i("LoadW", ri=4, a=128),
        _i("Xor", ri=5, rj=4, areg=1),
        _i("Shl", ri=6, rj=5, a=13),
        _i("Shr", ri=7, rj=5, a=17),
        _i("Or", ri=1, rj=1, areg=6),
        _i("UMulh", ri=2, rj=3, areg=7),
        _i("Cmpae", ri=2, areg=3),
        _i("CMov", ri=3, a=m(0xDEADBEEF)),
        _i("SMulh", ri=4, rj=3, areg=5),
        _i("UMod", ri=5, rj=4, a=251),
        _i("Cmpge", ri=6, areg=5),
    ]
    iters = max(1, (steps - 2) // (len(body) + 3))
    prog = [_i("Mov", ri=0, a=iters)]
    loop_start = len(prog)
    prog += body
    prog += [
        _i("Sub", ri=0, rj=0, a=1),
        _i("Cmpe", ri=0, a=0),
        _i("CnJmp", a=loop_start),
        _i("Answer", areg=3),
    ]
    return prog
