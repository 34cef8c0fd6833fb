from . import host
from .vesta import (
    PointBatch,
    add,
    add_mixed,
    double,
    eq,
    from_affine_host,
    identity,
    is_identity,
    neg,
    scalar_mul,
    select,
    to_affine_host,
)
from .msm import msm, msm_many, scalar_digits

__all__ = [
    "host",
    "PointBatch",
    "add",
    "add_mixed",
    "double",
    "eq",
    "from_affine_host",
    "identity",
    "is_identity",
    "neg",
    "scalar_mul",
    "select",
    "to_affine_host",
    "msm",
    "msm_many",
    "scalar_digits",
]
