"""TinyRAM 2.0 instruction set (Harvard architecture).

Mirrors the reference ISA exactly: 26 instructions with 5-bit opcodes
(reference/src/instructions.rs:78-107) and the `ri/rj/a` operand
accessors (instructions.rs:118-210).  `a` is either an immediate word or a
register name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# opcode table — instructions.rs:78-107 (TinyRAM 2.0 spec page 16)
OPCODES = {
    "And": 0b00000,
    "Or": 0b00001,
    "Xor": 0b00010,
    "Not": 0b00011,
    "Add": 0b00100,
    "Sub": 0b00101,
    "Mull": 0b00110,
    "UMulh": 0b00111,
    "SMulh": 0b01000,
    "UDiv": 0b01001,
    "UMod": 0b01010,
    "Shl": 0b01011,
    "Shr": 0b01100,
    "Cmpe": 0b01101,
    "Cmpa": 0b01110,
    "Cmpae": 0b01111,
    "Cmpg": 0b10000,
    "Cmpge": 0b10001,
    "Mov": 0b10010,
    "CMov": 0b10011,
    "Jmp": 0b10100,
    "CJmp": 0b10101,
    "CnJmp": 0b10110,
    "StoreW": 0b11100,
    "LoadW": 0b11101,
    "Answer": 0b11111,
}

ANSWER_OPCODE = OPCODES["Answer"]

# operand shape per mnemonic
HAS_RI_RJ = {
    "And", "Or", "Xor", "Add", "Sub", "Mull", "UMulh", "SMulh",
    "UDiv", "UMod", "Shl", "Shr",
}
HAS_RI_ONLY = {
    "Not", "Cmpe", "Cmpa", "Cmpae", "Cmpg", "Cmpge", "Mov", "CMov",
    "LoadW", "StoreW",
}
HAS_A_ONLY = {"Jmp", "CJmp", "CnJmp", "Answer"}

ALL_MNEMONICS = sorted(OPCODES)


@dataclass(frozen=True)
class Imm:
    value: int


@dataclass(frozen=True)
class Reg:
    index: int


Operand = Imm | Reg


@dataclass(frozen=True)
class Instruction:
    op: str
    ri: Optional[int] = None
    rj: Optional[int] = None
    a: Operand = Imm(0)

    def __post_init__(self):
        assert self.op in OPCODES, f"unknown op {self.op}"
        if self.op in HAS_RI_RJ:
            assert self.ri is not None and self.rj is not None
        elif self.op in HAS_RI_ONLY:
            assert self.ri is not None and self.rj is None
        else:
            assert self.ri is None and self.rj is None

    @property
    def opcode(self) -> int:
        return OPCODES[self.op]

    def a_value(self, regs) -> int:
        """[A] resolved against a register file (trace.rs:128-138)."""
        if isinstance(self.a, Imm):
            return self.a.value
        return int(regs[self.a.index])

    def immediate(self) -> int:
        """The immediate field as stored in the Prog table (0 when reg)."""
        return self.a.value if isinstance(self.a, Imm) else 0

    def __str__(self):
        parts = [self.op]
        if self.ri is not None:
            parts.append(f"r{self.ri}")
        if self.rj is not None:
            parts.append(f"r{self.rj}")
        parts.append(
            f"{self.a.value}" if isinstance(self.a, Imm) else f"r{self.a.index}"
        )
        return " ".join(parts)


Program = list[Instruction]


def word_mask(word_bits: int) -> int:
    return (1 << word_bits) - 1


def decode_signed(w: int, word_bits: int) -> int:
    """Haskell-emulator-compatible signed decode (trace.rs:554-563)."""
    m = 1 << (word_bits - 1)
    return (w & (m - 1)) - (w & m)


def truncate(x: int, word_bits: int) -> int:
    return x & word_mask(word_bits)
