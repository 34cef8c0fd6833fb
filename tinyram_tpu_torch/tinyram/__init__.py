from .isa import Imm, Instruction, Program, Reg
from .emulator import Trace, eval_program
from .circuit import TinyRamCircuit, gen_proof_and_verify

__all__ = [
    "Imm",
    "Instruction",
    "Program",
    "Reg",
    "Trace",
    "eval_program",
    "TinyRamCircuit",
    "gen_proof_and_verify",
]
