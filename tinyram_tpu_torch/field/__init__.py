from .params import FieldParams, fp_params, fq_params, int_to_limbs, limbs_to_int
from .field import FP, FQ, Field

__all__ = [
    "FieldParams",
    "fp_params",
    "fq_params",
    "int_to_limbs",
    "limbs_to_int",
    "FP",
    "FQ",
    "Field",
]
