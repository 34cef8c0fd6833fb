"""Kernel B1: elementwise Montgomery multiply, a·b·2^-256 mod p.

Replaces the Pallas kernel `_mul_pallas` of `tinyram_tpu/field/pallas_mul.py`
(its body `mont_mul_vecs`, dispatched from `jfield.Field._mul_dispatch`).

`mont_mul(a, b, params)` takes two `(16, n)` int32 limb arrays (16-bit limbs,
Montgomery form, canonical in [0, p)) and returns the canonical product.  A
CUDA tensor goes to the kernel `tr_mont_mul` of `csrc/mont_mul.cu`, a CPU
tensor to the plain version `mont_mul_plain`; nothing else is accepted.

Source note (the kernel, `csrc/mont_mul.cu` over `csrc/field.cuh`): one
thread per element gathers its 16 limbs (limb i of element j at i·n + j, so
a warp's loads of one limb row are coalesced), packs them into 8 32-bit
words, runs CIOS Montgomery with R = 2^256 (eight word steps, n0' taken mod
2^32, 64-bit accumulators), subtracts p once if needed and unpacks.  At this
layout a product moves 3 × 64 B (two operands, one result) for ~130 32-bit
multiplies, so on the H100 it should be bound by device memory, not by the
integer units; the design keeps the one-read-one-write shape and leaves
packed layouts (half the bytes) to later work.  ptxas (CUDA 12.8,
sm_90a): 38 registers, no spills.
"""

from __future__ import annotations

import torch

from .. import kernels
from .params import LIMB_BITS, LIMB_MASK, N_LIMBS, FieldParams

_TWO16 = float(1 << LIMB_BITS)
_TABLES: dict = {}  # (name, device) -> small constant tensor


def _table(name: str, device, make) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABLES:
        _TABLES[key] = make().to(device)
    return _TABLES[key]


def _field_id(params: FieldParams) -> int:
    return {"Fp": 0, "Fq": 1}[params.name]


def _p_limbs(params: FieldParams) -> list[int]:
    p = params.modulus
    return [(p >> (LIMB_BITS * i)) & 0xFFFF for i in range(N_LIMBS)]


def p_column(params: FieldParams, like: torch.Tensor) -> torch.Tensor:
    """p's limbs as an int32 column (16, 1, ...) shaped for `like`."""
    col = _table(params.name + ".p", like.device, lambda: torch.tensor(
        _p_limbs(params), dtype=torch.int32))
    return col.view((N_LIMBS,) + (1,) * (like.dim() - 1))


def carry_(s: torch.Tensor) -> torch.Tensor:
    """Propagate carries or borrows along the limb axis in place and drop
    the last one (limbs may be negative: `>>` floors)."""
    for i in range(N_LIMBS - 1):
        s[i + 1] += s[i] >> LIMB_BITS
    s &= LIMB_MASK
    return s


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, params: FieldParams):
    """Plain PyTorch version of B1 on `(16, n)` int32 limbs.

    Works in float64, where every intermediate is an integer below 2^40:
    limb products are < 2^32, a column sums at most 32 of them plus carries.
    Schoolbook product into 32 columns, then the 16-bit-digit Montgomery
    reduction (SOS, as `mont_mul_vecs`; the Pasta primes' zero limbs 8-14
    are skipped), one carry pass and one conditional subtraction of p.
    """
    n = a.shape[1]
    dev = a.device
    fa = a.to(torch.float64)
    fb = b.to(torch.float64)
    top = N_LIMBS - 1
    cols = torch.empty(2 * N_LIMBS, n, dtype=torch.float64, device=dev)
    torch.mul(fa[0:1], fb, out=cols[0:N_LIMBS])
    for i in range(1, N_LIMBS):
        cols[i : i + top].addcmul_(fa[i : i + 1], fb[:top])
        torch.mul(fa[i], fb[top], out=cols[i + top])
    cols[2 * N_LIMBS - 1].zero_()
    pl = _p_limbs(params)
    lo = [j for j in range(top) if pl[j]]
    j0, j1 = min(lo), max(lo) + 1
    if any(pl[j] for j in range(j1, top)) or params.n0_inv != LIMB_MASK:
        raise ValueError(f"{params.name}: not a Pasta-shaped prime")
    p_lo = torch.tensor(pl[j0:j1], dtype=torch.float64, device=dev)[:, None]
    p_top = float(pl[top])
    for i in range(N_LIMBS):
        ci = cols[i]
        # m = -c_i / p mod 2^16 = -c_i mod 2^16, since p = 1 mod 2^16
        m = torch.remainder(-ci, _TWO16)
        cols[i + j0 : i + j1].addcmul_(p_lo, m[None])
        cols[i + top].add_(m, alpha=p_top)
        # cols[i] is now a multiple of 2^16: push it into the next column
        cols[i + 1].add_(ci, alpha=1.0 / _TWO16)
    t = carry_(cols[N_LIMBS:].to(torch.int64)).to(torch.int32)
    return _cond_sub_p(t, params)


def _cond_sub_p(t: torch.Tensor, params: FieldParams) -> torch.Tensor:
    """Reduce int32 limbs (16, ...) known to be < 2p into [0, p)."""
    d = t - p_column(params, t)
    for i in range(N_LIMBS - 1):
        d[i + 1] += d[i] >> LIMB_BITS
    keep = d[N_LIMBS - 1] < 0  # borrow out: t < p
    d &= LIMB_MASK
    return blend(keep, t, d)


def blend(keep: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """where(keep, a, b) for 0/1 int `keep` shaped like the batch
    (arithmetic: CPU `torch.where` over limbs is several times slower)."""
    return b + (a - b) * keep.to(a.dtype)[None]


def mont_mul(a: torch.Tensor, b: torch.Tensor, params: FieldParams):
    """B1's wrapper: `(16, n)` int32 a·b/R mod p, kernel on CUDA."""
    if a.shape != b.shape or a.dim() != 2 or a.shape[0] != N_LIMBS:
        raise ValueError(f"mont_mul: shapes {tuple(a.shape)} {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul: limbs must be torch.int32")
    if a.device != b.device:
        raise ValueError("mont_mul: operands on different devices")
    if a.device.type == "cpu":
        return mont_mul_plain(a, b, params)
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul: unsupported device {a.device}")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    n = a.shape[1]
    if n == 0:
        return out
    lib = kernels.library()
    mont_mul.launches += 1
    mont_mul.widest = max(mont_mul.widest, n)
    kernels.check(
        lib.tr_mont_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            _field_id(params), kernels.stream_ptr(a.device),
        ),
        "tr_mont_mul",
    )
    return out


kernels.register("B1", mont_mul)
