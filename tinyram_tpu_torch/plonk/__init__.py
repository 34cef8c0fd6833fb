from .circuit import Assignment, Column, ConstraintSystem
from .expr import Const, Expr, Var
from .keygen import ProvingKey, VerifyingKey, keygen
from .prover import create_proof
from .verifier import verify_proof

__all__ = [
    "Assignment",
    "Column",
    "ConstraintSystem",
    "Const",
    "Expr",
    "Var",
    "ProvingKey",
    "VerifyingKey",
    "keygen",
    "create_proof",
    "verify_proof",
]
