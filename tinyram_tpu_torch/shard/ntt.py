"""Sharded NTT: the four-step algorithm with all-to-all stage exchanges.

Port of `tinyram_tpu/shard/ntt.py`.  A size-n transform is split as
n = R·C (`_split_rc`); each rank holds a block of n/D consecutive
elements.  Column NTTs of size R run rank-local after a tiled all-to-all,
then the twiddle multiply by ω^{s·u} (kernel B1 on the card), a second
all-to-all, row NTTs of size C, and a third all-to-all restores natural
order.  Both compute phases are the single-device `poly.ntt`, so on the
card they run kernel B2 wherever R or C is at least `NTT_KERNEL_MIN`.

Derivation (index split j = q·C + s, k = t·R + u):
  A[tR+u] = NTT_C over s of [ ω_n^{su} · (NTT_R over q of a[qC+s])[u, s] ]
"""

from __future__ import annotations

import torch

from ..field.field import FP, Field
from ..poly.ntt import ntt, omega_for, powers_device
from .mesh import Mesh


def _split_rc(log_n: int):
    R = 1 << ((log_n + 1) // 2)
    return R, (1 << log_n) // R


_TWIDDLES: dict = {}


def _twiddle_block(mesh: Mesh, log_n: int, inverse: bool) -> torch.Tensor:
    """(16, R, C/D) Montgomery table of ω^{u·s} for this rank's columns s,
    cached per (mesh, log n, direction).  Built on the device: ω^s for the
    rank's s by `powers_device`, then their powers u < R by doubling
    (log R batched products), equal bit for bit to the JAX package's
    `_twiddle_matrix` block (Montgomery products are exact and canonical)."""
    key = (mesh, log_n, inverse)
    if key not in _TWIDDLES:
        R, C = _split_rc(log_n)
        w = FP.const(omega_for(FP, log_n, inverse), 0, mesh.device)
        col = mesh.block(powers_device(FP, w, C))[:, None, :]  # ω^s (16, 1, C/D)
        out = FP.ones((1, col.shape[-1]), mesh.device)
        cur = col
        while out.shape[1] < R:  # out[:, u] = ω^{su} for u < len
            out = torch.cat([out, FP.mul(out, cur)], dim=1)
            cur = FP.mul(cur, cur)
        _TWIDDLES[key] = out
    return _TWIDDLES[key]


def ntt_sharded(mesh: Mesh, a: torch.Tensor, inverse: bool = False,
                field: Field = FP, n: int | None = None) -> torch.Tensor:
    """This rank's block of the NTT of a (16, ..., n) array along its last
    axis, from this rank's block `a` (16, ..., n/D) of the input: input and
    output block-sharded on the last axis, leading axes replicated; output
    in natural order (inverse=True includes the 1/n scale).  Needs
    R % D == 0 and C % D == 0 (`_split_rc`), over Fp.

    `n` (default D times `a`'s length): the size of a transform whose
    input is the ranks' blocks `a` followed by zeros, as the coset lift
    pads coefficients to n_ext.  The zero rows of the (R, C) input matrix
    are not exchanged: the first all-to-all sends the blocks as they are
    and every rank pads the columns it receives, so the pad costs no
    collective.  Needs each block to hold whole rows (its length a
    multiple of C)."""
    if field.params.name != "Fp":
        raise ValueError("ntt_sharded: Fp only (its twiddle table)")
    D = mesh.size
    n = a.shape[-1] * D if n is None else n
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"ntt_sharded: size {n} is not a power of two")
    R, C = _split_rc(log_n)
    if R % D or C % D:
        raise ValueError(f"ntt_sharded: mesh {D} must divide {R}x{C}")
    if a.shape[-1] % C or a.shape[-1] * D > n:
        raise ValueError(f"ntt_sharded: blocks of {a.shape[-1]} are not "
                         f"whole rows of {C} within {n}")
    lead = a.shape[:-1]
    ax = len(lead)  # index of the row axis once reshaped to (..., R/D, C)
    # block sharding of flat j = q·C + s gives each rank complete q-rows:
    # local (16, ..., rows/D, C); gather all q for a local s-chunk
    a_mat = mesh.all_to_all(a.reshape(*lead, a.shape[-1] // C, C), ax + 1, ax)
    if a_mat.shape[-2] < R:  # the zero rows of a padded input
        a_mat = torch.cat([a_mat, field.zeros(
            a_mat.shape[1:-2] + (R - a_mat.shape[-2], C // D), a.device)],
            dim=-2)
    # column NTTs (size R) along q: (16, ..., R, C/D)
    f1 = ntt(field, a_mat.movedim(-2, -1).contiguous(), inverse)
    f1 = f1.movedim(-1, -2)
    tw = _twiddle_block(mesh, log_n, inverse)
    f1 = field.mul(f1, tw.reshape((tw.shape[0],) + (1,) * (ax - 1)
                                  + tw.shape[1:]))
    # (16, ..., R, C/D) -> (16, ..., R/D, C); row NTTs (size C)
    f1 = mesh.all_to_all(f1, ax, ax + 1)
    f2 = ntt(field, f1.contiguous(), inverse)  # local 1/R · 1/C = 1/n
    # natural order A[t·R+u]: transpose to [t, u] and reshard on t
    f2 = mesh.all_to_all(f2.movedim(-1, -2), ax, ax + 1)
    # (16, ..., C/D, R): local flat t_l·R + u is the natural block
    return f2.reshape(*lead, n // D)
