"""The digit-matmul NTT: radix-R DFT stages as int8 matrix products (PyTorch).

Port of `tinyram_tpu/poly/mxu_ntt.py`, same algorithm:

  * a field element (Montgomery limbs) is cut into D = 37 seven-bit digits,
    which fit int8 without carries;
  * a radix-R stage out[k, l] = Σ_j W[k, j]·x[j, l] becomes one int8 product
    over digits, acc[k1, k, k2, l] = Σ_j W7[k1, k, j]·X7[k2, j, l], with W in
    plain (non-Montgomery) form so Montgomery inputs stay Montgomery; column
    sums are at most R·127² < 2^21 and the anti-diagonal combine of the
    k1 + k2 = c terms stays below 2^27, exact in int32 for R <= 128;
  * the 73 digit columns are carried into 16-bit limbs and reduced mod p:
    value = lo + mid·2^256 + top·2^512, the high parts folded back with one
    Montgomery product each (`digits_cols_to_mont`).

`ntt_mxu` composes the stages with the port's four-step split
(`cuda_ntt.four_step` with this module's base, at most R_MAX = 128 points a
stage); the junction twiddles and the inverse's 1/n are `field.mul`
products (kernel B1 on the card).  On a CUDA tensor each stage is one
launch of kernel M1 (`cuda_mxu.py`); on a CPU tensor its plain version
`dft_stage_plain`, int64 digit products.  `ntt(..., method="mxu")` in
`poly/ntt.py` routes transforms here, as the reference's `TINYRAM_NTT=mxu`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field.cuda_mul import _cond_sub_p
from ..field.field import Field
from ..field.params import N_LIMBS
from .ntt import _field, omega_for

DIGIT_BITS = 7
N_DIGITS = 37  # ceil(256 / 7)
N_COLS = 2 * N_DIGITS - 1  # 73 anti-diagonal columns
R_MAX = 128  # largest radix of one stage: the column-sum bound holds up to it
LOG_R_MAX = R_MAX.bit_length() - 1
N_WIDE = 34  # 16-bit limbs of a combined value: ceil(517 / 16) + 1
PRODUCT_ELEMS = 1 << 24  # int64 entries of one chunk of the plain product


def limbs_to_digits7(x: torch.Tensor) -> torch.Tensor:
    """(16, ...) int32 16-bit limbs -> (37, ...) int8 7-bit digits.

    Pure bit-slicing: digit i covers value bits [7i, 7i+7), which span at
    most two 16-bit limbs."""
    outs = []
    for i in range(N_DIGITS):
        l0, s = divmod(DIGIT_BITS * i, 16)
        d = x[l0] >> s
        if s + DIGIT_BITS > 16 and l0 + 1 < N_LIMBS:
            d = d | (x[l0 + 1] << (16 - s))
        outs.append(d & 0x7F)
    return torch.stack(outs).to(torch.int8)


@lru_cache(maxsize=None)
def _dft_digit_matrix(field_name: str, log_r: int, inverse: bool,
                      scale: int = 1) -> np.ndarray:
    """(37, R, R) int8 host table: the 7-bit digits of scale·ω_R^(kj) mod p
    in plain (non-Montgomery) form."""
    f = _field(field_name)
    p = f.modulus
    R = 1 << log_r
    w = omega_for(f, log_r, inverse)
    pows = [1] * R
    for i in range(1, R):
        pows[i] = pows[i - 1] * w % p
    vals = np.array([[pows[(k * j) % R] * scale % p for j in range(R)]
                     for k in range(R)], dtype=object)
    out = np.zeros((N_DIGITS, R, R), dtype=np.int8)
    for i in range(N_DIGITS):
        out[i] = ((vals >> (DIGIT_BITS * i)) & 0x7F).astype(np.int8)
    return out


def _fold(field: Field, acc: torch.Tensor) -> torch.Tensor:
    """`digits_cols_to_mont` with the given field's products."""
    acc = acc.to(torch.int64)
    batch = acc.shape[1:]
    # column c has weight 2^(7c); its value (< 2^27) spans three 16-bit
    # limbs.  Per-limb sums stay below 2^20.
    limbs = [torch.zeros(batch, dtype=torch.int64, device=acc.device)
             for _ in range(N_WIDE)]
    for c in range(N_COLS):
        l0, s = divmod(DIGIT_BITS * c, 16)
        v = acc[c]
        limbs[l0] = limbs[l0] + ((v << s) & 0xFFFF)
        limbs[l0 + 1] = limbs[l0 + 1] + ((v >> (16 - s)) & 0xFFFF)
        if s > 5:  # bits above 32 - s exist only when s + 27 > 32
            limbs[l0 + 2] = limbs[l0 + 2] + (v >> (32 - s))
    carry = torch.zeros(batch, dtype=torch.int64, device=acc.device)
    norm = []
    for limb in limbs:
        t = limb + carry
        norm.append(t & 0xFFFF)
        carry = t >> 16
    lo = torch.stack(norm[:16]).to(torch.int32)  # < 2^256
    mid = torch.stack(norm[16:32]).to(torch.int32)  # < 2^256
    top = torch.stack(norm[32:34] + [torch.zeros_like(carry)] * 14).to(
        torch.int32)  # < 2^32
    # hi·2^k mod p by one Montgomery product: const(v) holds v·R, so
    # mont_mul(hi, const(2^k)) = hi·2^k (mod p)
    c256 = field.const(pow(2, 256, field.modulus), len(batch), acc.device)
    c512 = field.const(pow(2, 512, field.modulus), len(batch), acc.device)
    mid_part = field.mul(mid, c256)
    top_part = field.mul(top, c512)
    out = lo  # < 2^256 < 4p: three conditional subtracts
    for _ in range(3):
        out = _cond_sub_p(out, field.params)
    return field.add(field.add(out, mid_part), top_part)


def digits_cols_to_mont(field_name: str, acc: torch.Tensor) -> torch.Tensor:
    """(73, ...) anti-diagonal digit columns (weight 2^(7c), each < 2^27) ->
    (16, ...) int32 canonical limbs mod p.

    Carry-normalize the columns into 16-bit limbs (total < R·p² < 2^517),
    split value = lo + mid·2^256 + top·2^512 and fold the high parts back
    with one Montgomery product each by the constants 2^256·R and
    2^512·R mod p."""
    return _fold(_field(field_name), acc)


def _digit_product(W7: torch.Tensor, X7: torch.Tensor) -> torch.Tensor:
    """(37, R, R) and (37, R, L) int8 digits -> (73, R, L) int64 columns
    col[c] = Σ_{k1+k2=c} Σ_j W7[k1, :, j]·X7[k2, j, :].

    int64 products on the CPU; float64 on the card, where integer matrix
    products are not offered (every sum over j is an integer below 2^21,
    exact in float64)."""
    R, L = X7.shape[1], X7.shape[2]
    dt = torch.int64 if X7.device.type == "cpu" else torch.float64
    lhs = W7.to(dt).reshape(N_DIGITS * R, R)
    rhs = X7.to(dt).permute(1, 0, 2).reshape(R, N_DIGITS * L)
    acc = (lhs @ rhs).reshape(N_DIGITS, R, N_DIGITS, L).to(torch.int64)
    cols = torch.zeros((N_COLS, R, L), dtype=torch.int64, device=X7.device)
    for k1 in range(N_DIGITS):
        cols[k1:k1 + N_DIGITS] += acc[k1].transpose(0, 1)
    return cols


def dft_stage_plain(x: torch.Tensor, field: Field, log_r: int, inverse: bool,
                    scale: int = 1) -> torch.Tensor:
    """Plain PyTorch version of M1: the radix-R DFT along axis 1 of
    x (16, R, L), the digit product chunked over L so that the
    (37·R, 37·L) product is never held whole."""
    R, L = 1 << log_r, x.shape[2]
    W7 = torch.as_tensor(
        _dft_digit_matrix(field.params.name, log_r, inverse, scale),
        device=x.device)
    out = torch.empty((N_LIMBS, R, L), dtype=torch.int32, device=x.device)
    chunk = max(1, PRODUCT_ELEMS // (N_DIGITS * N_DIGITS * R))
    for lo in range(0, L, chunk):
        X7 = limbs_to_digits7(x[:, :, lo:lo + chunk])
        out[:, :, lo:lo + chunk] = _fold(field, _digit_product(W7, X7))
    return out


def dft_stage(x: torch.Tensor, field_name: str, log_r: int, inverse: bool,
              scale: int = 1) -> torch.Tensor:
    """One radix-R DFT along axis 1 of x (16, R, L) Montgomery limbs: kernel
    M1 on a CUDA tensor, `dft_stage_plain` on a CPU tensor."""
    from .cuda_mxu import dft_stage_m1

    return dft_stage_m1(x, field_name, log_r, inverse, scale)


def _base_mxu(x: torch.Tensor, field: Field, inverse: bool, mult=None,
              scale=None) -> torch.Tensor:
    """`four_step`'s sub-transform: the DFT of each row of x (16, rows, S)
    as one M1 stage over the (16, S, rows) view, then the row multiplier
    `mult` (16, M, S) (row r times mult[:, r % M]) and the scalar `scale`
    by `field.mul`."""
    rows, S = x.shape[1], x.shape[2]
    y = dft_stage(x.transpose(1, 2), field.params.name, S.bit_length() - 1,
                  inverse).transpose(1, 2)
    if mult is not None:
        M = mult.shape[1]
        y = field.mul(y.reshape(N_LIMBS, rows // M, M, S),
                      mult[:, None]).reshape(N_LIMBS, rows, S)
    if scale is not None:
        y = field.mul(y, scale.reshape(N_LIMBS, 1, 1))
    return y


def ntt_mxu(field: Field, a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Drop-in for `poly.ntt.ntt` with digit-matmul DFT stages: (16, ..., n)
    transform along the last axis."""
    from .cuda_ntt import four_step

    n = a.shape[-1]
    assert n & (n - 1) == 0, "NTT size must be a power of two"
    if n == 1:
        return a
    x = a.reshape(N_LIMBS, -1, n).contiguous()
    scale = None
    if inverse:
        scale = field.const(pow(n, field.modulus - 2, field.modulus), 0,
                            a.device)
    out = four_step(x, field, inverse, scale, log_s_max=LOG_R_MAX,
                    base=_base_mxu)
    return out.reshape(a.shape)


__all__ = ["DIGIT_BITS", "N_DIGITS", "N_COLS", "R_MAX", "limbs_to_digits7",
           "digits_cols_to_mont", "dft_stage", "dft_stage_plain", "ntt_mxu"]
