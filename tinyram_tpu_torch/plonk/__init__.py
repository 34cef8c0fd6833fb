from .circuit import Assignment, Column, ConstraintSystem
from .expr import Const, Expr, Var
from .keygen import ProvingKey, VerifyingKey, keygen
from .mock import MockProver
from .prover import create_proof
from .verifier import verify_proof
from .batch import BatchVerifier
from .layout import layout_dot, layout_summary
from .serialize import load_pk, save_pk

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
    "MockProver",
    "create_proof",
    "verify_proof",
    "BatchVerifier",
    "layout_dot",
    "layout_summary",
    "load_pk",
    "save_pk",
]
