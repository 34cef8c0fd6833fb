"""Kernel B2: batched natural-order NTT rows, and the four-step composition.

Replaces the Pallas kernel `_colntt_kernel_call` of
`tinyram_tpu/poly/pallas_ntt.py` (body `_ntt_stages`, composed by
`four_step`, `colntt` and `ntt_pallas`).

`colntt(x, field, inverse, mult, scale)` transforms every row of a
`(16, rows, S)` int32 limb array along its last axis (S <= 2^LOG_S_MAX),
natural order in and out, then multiplies row r by `mult[:, r % M]` (an
optional `(16, M, S)` table) and by the optional scalar `scale` (16,).  A
CUDA tensor goes to the kernel `tr_ntt` of `csrc/ntt.cu`, a CPU tensor to
the plain version `colntt_plain`.  `ntt_cuda` builds any power-of-two size
from it: with S = a·b it transforms the a-point columns, fuses the cross
twiddles ω_S^(k1·i2) as their output multiplier, transposes, and recurses
on b; the inverse folds 1/n into the last level as `scale`.

Source note (the kernel): one block owns one row.  It loads the S elements
into shared memory in bit-reversed order (8 32-bit words each, 32 B), runs
the log2 S radix-2 Cooley-Tukey stages with `__syncthreads()` between
them, each thread doing butterflies with the field.cuh Montgomery multiply,
applies the multipliers and writes natural order.  The base size is 1024
points (32 KB of shared memory, under the 48 KB static limit) where the TPU
kernel stopped at 256, so 2^14 and 2^16 transforms take two levels.  A
butterfly is one 8-word Montgomery product plus an add and a subtract, so
at S = 128..1024 the kernel does 7-10 products per element against two
64 B device-memory passes: it should be bound by the integer multiply rate,
and the design keeps every stage in shared memory so only the loads, the
stores and the four-step transposes touch device memory.  ptxas (CUDA
12.8, sm_90a): 52 registers, no spills.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from ..field.field import Field, plain
from ..field.params import N_LIMBS
from .ntt import _field, _mont_table, omega_for, radix2_stages

LOG_S_MAX = 10  # largest row transform of one kernel launch: 1024 points


@lru_cache(maxsize=None)
def _row_twiddles_host(field_name: str, log_s: int, inverse: bool):
    """(16, S/2) table of ω_S^k, k < S/2, Montgomery form."""
    f = _field(field_name)
    p = f.modulus
    w = omega_for(f, log_s, inverse)
    vals = [1] * max(1, (1 << log_s) // 2)
    for k in range(1, len(vals)):
        vals[k] = vals[k - 1] * w % p
    return _mont_table(f, vals)


@lru_cache(maxsize=None)
def _cross_twiddles_host(field_name: str, log_a: int, log_b: int, inverse: bool):
    """(16, b, a) table: entry [i2, k1] = ω_{a·b}^(k1·i2), Montgomery form."""
    f = _field(field_name)
    p = f.modulus
    s_len = 1 << (log_a + log_b)
    omega = omega_for(f, log_a + log_b, inverse)
    pows = [1] * s_len
    for i in range(1, s_len):
        pows[i] = pows[i - 1] * omega % p
    a, b = 1 << log_a, 1 << log_b
    idx = np.multiply.outer(np.arange(b), np.arange(a)).ravel()  # < a·b
    return _mont_table(f, [pows[i] for i in idx]).reshape(N_LIMBS, b, a)


_DEVICE_TABLES: dict = {}


def _on_device(key, make, device):
    k = key + (str(device),)
    if k not in _DEVICE_TABLES:
        _DEVICE_TABLES[k] = torch.as_tensor(make(), device=device)
    return _DEVICE_TABLES[k]


def colntt_plain(x, field: Field, inverse: bool, mult=None, scale=None):
    """Plain PyTorch version of B2 (radix-2 stages of `poly.ntt`, with
    B1's plain multiply)."""
    field = plain(field)
    y = radix2_stages(field, x, inverse)
    if mult is not None:
        _, rows, S = y.shape
        M = mult.shape[1]
        y = field.mul(
            y.reshape(N_LIMBS, rows // M, M, S), mult[:, None]
        ).reshape(N_LIMBS, rows, S)
    if scale is not None:
        y = field.mul(y, scale.reshape(N_LIMBS, 1, 1))
    return y


def colntt(x, field: Field, inverse: bool, mult=None, scale=None):
    """B2's wrapper: NTT of each row of x (16, rows, S) along axis 2."""
    if x.dim() != 3 or x.shape[0] != N_LIMBS or x.dtype != torch.int32:
        raise ValueError(f"colntt: bad input {tuple(x.shape)} {x.dtype}")
    rows, S = x.shape[1], x.shape[2]
    log_s = S.bit_length() - 1
    if 1 << log_s != S or not 1 <= log_s <= LOG_S_MAX:
        raise ValueError(f"colntt: row length {S} not in 2..2^{LOG_S_MAX}")
    if mult is not None and (mult.shape[0] != N_LIMBS or mult.shape[2] != S
                             or rows % mult.shape[1]):
        raise ValueError(f"colntt: bad multiplier {tuple(mult.shape)}")
    if x.device.type == "cpu":
        return colntt_plain(x, field, inverse, mult, scale)
    if x.device.type != "cuda":
        raise ValueError(f"colntt: unsupported device {x.device}")
    x = x.contiguous()
    tw = _on_device(
        ("tw", field.params.name, log_s, inverse),
        lambda: _row_twiddles_host(field.params.name, log_s, inverse),
        x.device,
    )
    for t in (mult, scale):
        if t is not None and (t.device != x.device or t.dtype != torch.int32):
            raise ValueError("colntt: multiplier not an int32 tensor on x's device")
    mult = mult.contiguous() if mult is not None else None
    scale = scale.contiguous() if scale is not None else None
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = kernels.library()
    colntt.launches += 1
    kernels.check(
        lib.tr_ntt(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(),
            mult.data_ptr() if mult is not None else None,
            mult.shape[1] if mult is not None else 1,
            scale.data_ptr() if scale is not None else None,
            rows, log_s, 0 if field.params.name == "Fp" else 1,
            kernels.stream_ptr(x.device),
        ),
        "tr_ntt",
    )
    return out


kernels.register("B2", colntt)


def four_step(x, field: Field, inverse: bool, scale=None,
              log_s_max: int = LOG_S_MAX, base=None):
    """NTT of each row of x (16, rows, S) for any power-of-two S, from
    sub-transforms of at most 2^log_s_max points: `base(x, field, inverse,
    mult, scale)`, which has `colntt`'s contract (`colntt` when None; the
    digit-matmul stage of `mxu_ntt.py` is the other)."""
    base = base or colntt
    rows, S = x.shape[1], x.shape[2]
    log_s = S.bit_length() - 1
    if log_s <= log_s_max:
        return base(x, field, inverse, None, scale)
    log_a = min(log_s_max, (log_s + 1) // 2)
    a, b = 1 << log_a, S >> log_a
    # index i = i1·b + i2: transform over i1 (rows (r, i2)), times ω_S^(k1·i2)
    xt = x.reshape(N_LIMBS, rows, a, b).transpose(2, 3).reshape(
        N_LIMBS, rows * b, a
    )
    cross = _on_device(
        ("cross", field.params.name, log_a, log_s - log_a, inverse),
        lambda: _cross_twiddles_host(
            field.params.name, log_a, log_s - log_a, inverse
        ),
        x.device,
    )
    # each level's copies are released as soon as the next is made: a
    # transform holds ~4 copies of its input at its peak, not one a level
    # (config 4's columns are 128 MiB each)
    y = base(xt.contiguous(), field, inverse, cross, None)  # [r, i2, k1]
    del xt
    yt = y.reshape(N_LIMBS, rows, b, a).transpose(2, 3).reshape(
        N_LIMBS, rows * a, b
    ).contiguous()
    del y
    z = four_step(yt, field, inverse, scale, log_s_max, base)
    del yt
    # z[r, k1, k2] holds output index k = k1 + a·k2
    return z.reshape(N_LIMBS, rows, a, b).transpose(2, 3).reshape(
        N_LIMBS, rows, S
    )


def ntt_cuda(field: Field, a: torch.Tensor, inverse: bool = False,
             log_s_max: int = LOG_S_MAX) -> torch.Tensor:
    """Drop-in for `poly.ntt.ntt`: (16, ..., n) transform along the last
    axis, through kernel B2 (its plain version on a CPU tensor)."""
    n = a.shape[-1]
    assert n & (n - 1) == 0 and n > 1
    x = a.reshape(N_LIMBS, -1, n).contiguous()
    scale = None
    if inverse:
        n_inv = pow(n, field.modulus - 2, field.modulus)
        scale = field.const(n_inv, 0, a.device)
    return four_step(x, field, inverse, scale, log_s_max).reshape(a.shape)
