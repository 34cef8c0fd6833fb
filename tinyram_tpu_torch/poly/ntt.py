"""Radix-2 NTT over the Pasta fields (PyTorch).

Port of `tinyram_tpu/poly/ntt.py`.  Arrays are limb-major `(16, ..., n)`
int32; the transform axis is the last one.  On a CUDA tensor, transforms of
n >= 512 points run the shared-memory kernel B2 through the four-step
composition of `cuda_ntt.py`, or, with `method="mxu"` (the reference's
`TINYRAM_NTT=mxu`), the int8 digit-matmul stages of `mxu_ntt.py` (kernel
M1) through the same composition; smaller ones, and every CPU transform,
run the iterative Cooley-Tukey stages below (bit-reversal gather, one
batched field multiply plus an add and a subtract per stage).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field.field import FP, FQ, Field
from ..field.params import N_LIMBS, ints_to_limb_array
from ..utils.algorithms import NTT_METHODS

NTT_KERNEL_MIN = 512  # smallest CUDA transform routed to kernel B2 or M1


def _bitrev_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _mont_table(field: Field, values) -> np.ndarray:
    """Python ints -> (16, len) Montgomery limb table (host numpy int32)."""
    r = field.params.r_mod_p
    p = field.modulus
    return ints_to_limb_array([(int(v) * r) % p for v in values])


def _field(name: str) -> Field:
    return FP if name == "Fp" else FQ


def omega_for(field: Field, log_n: int, inverse: bool = False) -> int:
    p = field.modulus
    w = pow(field.params.root_of_unity, 1 << (field.params.two_adicity - log_n), p)
    return pow(w, p - 2, p) if inverse else w


@lru_cache(maxsize=None)
def _stage_twiddles_host(field_name: str, log_n: int, inverse: bool):
    field = _field(field_name)
    p = field.modulus
    omega = omega_for(field, log_n, inverse)
    tables = []
    for s in range(log_n):
        m = 1 << s  # half-size of butterflies at this stage
        w = pow(omega, 1 << (log_n - 1 - s), p)  # primitive 2m-th root
        ws = [pow(w, j, p) for j in range(m)]
        tables.append(_mont_table(field, ws))
    return _bitrev_indices(log_n), tuple(tables)


_DEVICE_TABLES: dict = {}


def _stage_twiddles(field_name: str, log_n: int, inverse: bool, device):
    key = (field_name, log_n, inverse, str(device))
    if key not in _DEVICE_TABLES:
        rev, tables = _stage_twiddles_host(field_name, log_n, inverse)
        _DEVICE_TABLES[key] = (
            torch.as_tensor(rev, device=device),
            tuple(torch.as_tensor(t, device=device) for t in tables),
        )
    return _DEVICE_TABLES[key]


def radix2_stages(field: Field, a: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Natural-order NTT along the last axis without the 1/n scale."""
    n = a.shape[-1]
    log_n = n.bit_length() - 1
    rev, tables = _stage_twiddles(field.params.name, log_n, inverse, a.device)
    out = torch.index_select(a, -1, rev)
    lead = a.shape[:-1]  # (16, ...) leading dims
    for s in range(log_n):
        m = 1 << s
        groups = n // (2 * m)
        v = out.reshape(*lead, groups, 2, m)
        lo = v[..., 0, :]
        hi = v[..., 1, :]
        w = tables[s].reshape((N_LIMBS,) + (1,) * (len(lead) - 1) + (1, m))
        t = field.mul(hi, w)
        new_lo = field.add(lo, t)
        new_hi = field.sub(lo, t)
        out = torch.stack([new_lo, new_hi], dim=-2).reshape(*lead, n)
    return out


def ntt(field: Field, a: torch.Tensor, inverse: bool = False,
        method: str = "b2") -> torch.Tensor:
    """In-order NTT of `a` (16, ..., n) along the last axis.

    Forward: coeffs -> evals at (1, ω, ω², …) in natural order.
    Inverse: evals -> coeffs (including the 1/n scale).

    `method` picks the algorithm of CUDA transforms of >= NTT_KERNEL_MIN
    points: "b2" the butterflies of kernel B2, "mxu" the int8
    digit-matmul stages of `mxu_ntt.ntt_mxu` (kernel M1), where the
    reference reads `TINYRAM_NTT=mxu`.  Both give the same outputs.
    """
    if method not in NTT_METHODS:
        raise ValueError(f"ntt: method {method!r} not in {NTT_METHODS}")
    n = a.shape[-1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "NTT size must be a power of two"
    if n == 1:
        return a
    if n >= NTT_KERNEL_MIN and a.device.type == "cuda":
        if method == "mxu":
            from .mxu_ntt import ntt_mxu

            return ntt_mxu(field, a, inverse=inverse)
        from .cuda_ntt import ntt_cuda

        return ntt_cuda(field, a, inverse=inverse)
    out = radix2_stages(field, a, inverse)
    if inverse:
        n_inv = pow(n, field.modulus - 2, field.modulus)
        out = field.mul(out, field.const(n_inv, out.dim() - 1, out.device))
    return out


def powers(field: Field, base: int, n: int, first: int = 1) -> np.ndarray:
    """Host table [1, b, b², …, b^{n-1}] times `first` (Montgomery limbs,
    numpy)."""
    p = field.modulus
    vals = [first % p] * n
    for i in range(1, n):
        vals[i] = (vals[i - 1] * base) % p
    return _mont_table(field, vals)


def powers_device(field: Field, x: torch.Tensor, n: int) -> torch.Tensor:
    """Device-computed powers [1, x, …, x^{n-1}] for a device scalar x (16,).

    Log-doubling: O(log n) batched multiplies, no serial chain.
    """
    assert n & (n - 1) == 0, "n must be a power of two"
    out = field.ones((1,), device=x.device)  # (16, 1)
    cur = x[:, None]  # x^(2^j) as (16, 1)
    length = 1
    while length < n:
        out = torch.cat([out, field.mul(out, cur)], dim=1)
        cur = field.mul(cur, cur)
        length *= 2
    return out


def coeff_scale(field: Field, a: torch.Tensor, g: int,
                offset: int = 0) -> torch.Tensor:
    """Scale coefficient i by g^(offset + i) (used for coset evaluation;
    `offset`: where a row block of a longer vector starts).

    The table [g^offset, ..., g^(offset+n-1)] is built on the host once per
    (field, g, offset, n, device) and kept: rebuilt on every call (a Python
    loop of n modular products), it took most of the GPU prover's quotient
    phase."""
    n = a.shape[-1]
    key = ("coset", field.params.name, g, n, str(a.device))
    if offset:
        key += (offset,)
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = torch.as_tensor(
            powers(field, g, n, pow(g, offset, field.modulus)),
            device=a.device)
    tbl = _DEVICE_TABLES[key]
    return field.mul(a, tbl.reshape((N_LIMBS,) + (1,) * (a.dim() - 2) + (n,)))


def eval_poly(field: Field, coeffs: torch.Tensor, x: torch.Tensor,
              offset: int = 0):
    """Evaluate (16, ..., n) coefficient vectors at device scalar x (16,).
    `offset`: the vectors are the coefficients offset … offset + n − 1 of
    longer ones (a row block), so the result is Σ_i c_i x^(offset + i)."""
    n = coeffs.shape[-1]
    m = 1 << (n - 1).bit_length() if n > 1 else 1
    pw = powers_device(field, x, max(m, 1))[:, :n]
    if offset:
        pw = field.mul(pw, field.pow_const(x, offset)[:, None])
    pw = pw.reshape((coeffs.shape[0],) + (1,) * (coeffs.dim() - 2) + (n,))
    prods = field.mul(coeffs, pw)
    return tree_sum(field, prods)


def eval_poly_rows(field: Field, block: torch.Tensor, x: torch.Tensor):
    """`eval_poly` of whole coefficient vectors from this rank's row block
    (16, ..., n/D) of them under a mesh context: the block's partial sum
    x^(r·n/D)·Σ_i c_i x^i, then the sum over ranks (`Mesh.field_sum`), the
    same value on every rank.  With no mesh, `eval_poly` of the whole."""
    from ..shard.context import current_mesh

    mesh = current_mesh()
    if mesh is None:
        return eval_poly(field, block, x)
    part = eval_poly(field, block, x, offset=mesh.rank * block.shape[-1])
    return mesh.field_sum(part, field)


def tree_sum(field: Field, a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Field sum along an axis via log-depth pairwise reduction."""
    a = torch.movedim(a, axis, -1)
    n = a.shape[-1]
    while n > 1:
        if n % 2 == 1:
            a = torch.cat(
                [a, field.zeros(a.shape[1:-1] + (1,), device=a.device)], dim=-1
            )
            n += 1
        a = field.add(a[..., : n // 2], a[..., n // 2 :])
        n = a.shape[-1]
    return a[..., 0]
