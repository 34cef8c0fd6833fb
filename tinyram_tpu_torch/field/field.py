"""Batched prime-field arithmetic (PyTorch), shared by Fp and Fq.

Port of `tinyram_tpu/field/jfield.py`.  A field element batch is a
`torch.int32` tensor of shape `(16, *batch)`: 16 little-endian limbs of 16
bits (the same bits as the reference's uint32 arrays), Montgomery form with
R = 2^256, every value canonical in [0, p).

Multiplication on a CUDA tensor always runs kernel B1 (`cuda_mul.py`), with
broadcast operands expanded first; on a CPU tensor it runs B1's plain
version.  `FP_PLAIN`/`FQ_PLAIN` always run the plain version: the plain
versions of the other kernels are built on them, so that on the card a
kernel is compared with code that uses no kernel at all.  Addition and
subtraction are plain tensor code: a limb add, one carry pass over the 16
limbs and one conditional subtraction.  Inversion is
Fermat (x^(p-2)), so inv(0) = 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_mul import _cond_sub_p, blend, carry_, mont_mul, mont_mul_plain, p_column
from .params import (
    LIMB_BITS,
    LIMB_MASK,
    N_LIMBS,
    FieldParams,
    fp_params,
    fq_params,
    int_to_limbs,
    ints_to_limb_array,
    limbs_to_int,
)

I32 = torch.int32


def _const_limbs(x: int) -> np.ndarray:
    return np.array(int_to_limbs(x), dtype=np.int32)


class Field:
    """Vectorized modular arithmetic for one prime field.

    Methods take and return int32 tensors shaped `(16, *batch)` in
    Montgomery form unless stated otherwise.  Constructors of new tensors
    take an explicit `device`.
    """

    def __init__(self, params: FieldParams, plain: bool = False):
        self.params = params
        self.plain = plain
        self.modulus = params.modulus
        self._r = _const_limbs(params.r_mod_p)  # 1 in Montgomery form

    def _col(self, limbs: np.ndarray, ndim: int, device) -> torch.Tensor:
        return torch.as_tensor(limbs, device=device).reshape(
            (N_LIMBS,) + (1,) * (ndim - 1)
        )

    # ---------------------------------------------------------------- shapes

    def zeros(self, batch_shape=(), device="cpu") -> torch.Tensor:
        return torch.zeros((N_LIMBS,) + tuple(batch_shape), dtype=I32,
                           device=device)

    def ones(self, batch_shape=(), device="cpu") -> torch.Tensor:
        """Montgomery one, broadcast to a batch (a contiguous tensor)."""
        one = self._col(self._r, len(batch_shape) + 1, device)
        return one.expand((N_LIMBS,) + tuple(batch_shape)).contiguous()

    def const(self, value: int, batch_ndim: int = 0, device="cpu"):
        """Host int -> Montgomery constant shaped (16, 1, 1, ...)."""
        x = (value % self.modulus) * self.params.r_mod_p % self.modulus
        return self._col(_const_limbs(x), batch_ndim + 1, device)

    # ------------------------------------------------------------ arithmetic

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _cond_sub_p(carry_(a + b), self.params)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d = a - b
        for i in range(N_LIMBS - 1):
            d[i + 1] += d[i] >> LIMB_BITS
        borrow = (d[N_LIMBS - 1] < 0).to(I32)
        d &= LIMB_MASK
        d += borrow[None] * p_column(self.params, d)
        return carry_(d)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def double(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product aR * bR -> abR (mod p)."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        lanes = 1
        for d in shape[1:]:
            lanes *= d
        a = a.expand(shape).reshape(N_LIMBS, lanes)
        b = b.expand(shape).reshape(N_LIMBS, lanes)
        mul = mont_mul_plain if self.plain else mont_mul
        return mul(a, b, self.params).reshape(shape)

    def square(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    # ---------------------------------------------------------------- powers

    def pow_const(self, a: torch.Tensor, exponent: int) -> torch.Tensor:
        """a^exponent for a host-constant exponent (square and multiply)."""
        acc = self._col(self._r, a.dim(), a.device).expand(a.shape)
        acc = acc.contiguous()
        for bit in bin(exponent)[2:]:
            acc = self.mul(acc, acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        """Batched Fermat inversion; inv(0) = 0."""
        return self.pow_const(a, self.modulus - 2)

    # ------------------------------------------------------------ predicates

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return torch.all(a == 0, dim=0)

    def eq(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.all(a == b, dim=0)

    def select(self, mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
        """where(mask, a, b) with mask shaped like the batch."""
        return blend(mask.to(I32), a, b)

    # ------------------------------------------------------------ conversion

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        r2 = self._col(_const_limbs(self.params.r2_mod_p), a.dim(), a.device)
        return self.mul(a, r2)

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        one = torch.zeros_like(a)
        one[0] = 1
        return self.mul(a, one)

    def encode(self, ints, to_mont: bool = True, device="cpu") -> torch.Tensor:
        """Python ints (or a 1-D int numpy array) -> (16, N) tensor.

        Non-negative integer numpy arrays are limb-split vectorized and
        Montgomery-converted with one multiply on the device.
        """
        if isinstance(ints, np.ndarray) and ints.dtype != object and \
                ints.dtype.kind in "iu" and ints.ndim == 1 and \
                (ints.size == 0 or int(ints.min()) >= 0):
            vals = ints.astype(np.int64, copy=False)
            limbs = np.zeros((N_LIMBS, vals.shape[0]), dtype=np.int32)
            for i in range(4):
                limbs[i] = (vals >> (16 * i)) & 0xFFFF
            dev = torch.as_tensor(limbs, device=device)
            return self.to_mont(dev) if to_mont else dev
        factor = self.params.r_mod_p if to_mont else 1
        arr = ints_to_limb_array([int(x) * factor % self.modulus for x in ints])
        return torch.as_tensor(arr, device=device)  # (16, N)

    def encode_scalar(self, x: int, to_mont: bool = True, device="cpu"):
        return self.encode([x], to_mont=to_mont, device=device)[:, 0]

    def decode(self, arr: torch.Tensor, from_mont: bool = True) -> list[int]:
        """(16, ...) tensor -> list of Python ints."""
        if from_mont:
            arr = self.from_mont(arr)
        host = arr.reshape(N_LIMBS, -1).cpu().numpy().astype(np.int64)
        vals = host[N_LIMBS - 1].astype(object)
        for i in range(N_LIMBS - 2, -1, -1):
            vals = (vals << LIMB_BITS) | host[i].astype(object)
        return [int(v) for v in vals]

    def decode_i64(self, arr: torch.Tensor, from_mont: bool = True):
        """(16, ...) tensor -> int64 numpy array, or None if any value
        exceeds 62 bits (the caller falls back to the bigint path)."""
        if from_mont:
            arr = self.from_mont(arr)
        host = arr.reshape(N_LIMBS, -1).cpu().numpy().astype(np.int64)
        if host[4:].any() or (host[3] >> 14).any():
            return None
        out = host[0].copy()
        for i in range(1, 4):
            out |= host[i] << (16 * i)
        return out


FP = Field(fp_params())
FQ = Field(fq_params())
FP_PLAIN = Field(fp_params(), plain=True)
FQ_PLAIN = Field(fq_params(), plain=True)



def plain(field: Field) -> Field:
    """The field whose multiplies always run B1's plain version."""
    return FP_PLAIN if field.params.name == "Fp" else FQ_PLAIN


__all__ = ["Field", "FP", "FQ", "FP_PLAIN", "FQ_PLAIN", "plain",
           "limbs_to_int"]
