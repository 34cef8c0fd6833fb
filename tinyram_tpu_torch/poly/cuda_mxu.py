"""Kernel M1: one radix-R DFT stage of the digit-matmul NTT on the int8
tensor cores.

New device code: the JAX package computes this stage in XLA
(`tinyram_tpu/poly/mxu_ntt.py` `dft_stage` with `limbs_to_digits7` and
`digits_cols_to_mont`, one `dot_general` over the (37·R, R) and
(R, 37·L) digit matrices and the combine around it); no Pallas kernel.

`dft_stage_m1(x, field_name, log_r, inverse)` takes x (16, R, L) int32
Montgomery limbs (any strides; `_base_mxu` passes the transposed view of
the four-step's rows, so no copy is made), R = 2^log_r <= 128, and returns
the DFT along axis 1 in a tensor of x's strides: kernel `tr_mxu_dft` of
`csrc/mxu_ntt.cu` on a CUDA tensor, `mxu_ntt.dft_stage_plain` on a CPU
tensor.

Source note (the kernel).  A block owns 16 output rows k and 8 columns l
per warp (3 warps at R = 128, 7 at 64, 8 below).  It stages the 37 digit
planes of its 16 rows of the DFT table (a padded (37, max(R, 16),
max(R, 32)) int8 table on the device, zero past R) and of its columns'
inputs (cut into 7-bit digits as it loads them) in shared memory, each row
padded by 16 bytes so the fragment loads of a warp hit 32 different
banks.  Each warp then runs, for each of the 73 digit columns c, the
accumulation over the pairs k1 + k2 = c and the R/32 depth steps as
`mma.sync.m16n8k32` s8 products into int32 (two chains per depth step,
even and odd k1), so the tensor cores add the anti-diagonal and the
(37·R, 37·L) product is never stored.  After each column the four sums
a thread holds are carried into 16-bit limbs in a 64-bit running value
(one limb leaves per column at most, since 7 < 16); at the end each element
folds mid·2^256 and top·2^512 back with `field.cuh`'s `mont_mul_cc`,
subtracts p up to three times from lo and adds, in the order of
`digits_cols_to_mont`.  One stage is 2·37²·R int8 operations per element
(2·37²·128 = 350,464 at R = 128) against 128 bytes of device traffic, so it
is bound by the tensor cores' int8 rate, and 37² of the products are the
price of exact 7-bit digits.  The staging keeps every digit product in
shared memory and registers; what the simple design leaves is occupancy
(the 37 planes of 16 rows and 24 columns fill the 227 KB of one SM at
R = 128) and `mma.sync` where `wgmma` does four times the work an instruction.
The column values stay below 2^27 only for R <= 128 (the reference's
bound), so larger radices are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..field.field import plain
from ..field.params import N_LIMBS
from .cuda_ntt import _on_device
from .mxu_ntt import (LOG_R_MAX, N_DIGITS, _dft_digit_matrix, _field,
                      dft_stage_plain)


def _padded_digits(field_name: str, log_r: int, inverse: bool,
                   scale: int) -> np.ndarray:
    """The (37, R, R) digit table zero-padded to (37, max(R, 16),
    max(R, 32)): whole 16-row tiles and 32-digit depth steps."""
    w = _dft_digit_matrix(field_name, log_r, inverse, scale)
    R = 1 << log_r
    out = np.zeros((N_DIGITS, max(R, 16), max(R, 32)), dtype=np.int8)
    out[:, :R, :R] = w
    return out


def _fold_consts(field, device) -> torch.Tensor:
    """(16, 2) limbs: 2^256 and 2^512 mod p in Montgomery form."""
    p = field.modulus
    return torch.cat([field.const(pow(2, 256, p), 1, device),
                      field.const(pow(2, 512, p), 1, device)], dim=1).contiguous()


def dft_stage_m1(x: torch.Tensor, field_name: str, log_r: int, inverse: bool,
                 scale: int = 1) -> torch.Tensor:
    """M1's wrapper: the radix-2^log_r DFT along axis 1 of x (16, R, L)."""
    if x.dim() != 3 or x.shape[0] != N_LIMBS or x.dtype != torch.int32:
        raise ValueError(f"dft_stage: bad input {tuple(x.shape)} {x.dtype}")
    if not 1 <= log_r <= LOG_R_MAX or x.shape[1] != 1 << log_r:
        raise ValueError(f"dft_stage: radix {x.shape[1]} is not 2^{log_r} "
                         f"in 2..2^{LOG_R_MAX}")
    field = _field(field_name)
    if x.device.type == "cpu":
        return dft_stage_plain(x, plain(field), log_r, inverse, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dft_stage: unsupported device {x.device}")
    if not (x.is_contiguous() or x.transpose(1, 2).is_contiguous()):
        x = x.contiguous()
    out = torch.empty_like(x)  # dense: the same strides
    L = x.shape[2]
    if L == 0:
        return out
    w = _on_device(("digits", field_name, log_r, inverse, scale),
                   lambda: _padded_digits(field_name, log_r, inverse, scale),
                   x.device)
    consts = _on_device(("fold", field_name), lambda: _fold_consts(field, "cpu"),
                        x.device)
    lib = kernels.library()
    dft_stage_m1.launches += 1
    kernels.check(
        lib.tr_mxu_dft(
            x.data_ptr(), out.data_ptr(), w.data_ptr(), consts.data_ptr(),
            log_r, L, x.stride(0), x.stride(1), x.stride(2),
            0 if field_name == "Fp" else 1, kernels.stream_ptr(x.device),
        ),
        "tr_mxu_dft",
    )
    return out


kernels.register("M1", dft_stage_m1)
