"""Sharded Pippenger MSM: points sharded per rank, partials combined.

Port of `tinyram_tpu/shard/msm.py`.  Each rank runs the single-device MSM
(`curve.msm.msm` or `msm_many`, with c = `choose_window_bits(N / D)`) over
its block of points, which gives one projective partial sum per column;
the D partials are all-gathered and every rank adds them in rank order
from the identity, as the JAX `fori_loop` does, with kernel B4 on the card
(point addition is not a ring op, so the collective is an all-gather of
3 x 16 limb vectors per column, not a sum).
"""

from __future__ import annotations

import torch

from ..curve import vesta
from ..curve.cuda_point import padd
from ..curve.msm import choose_window_bits, msm, msm_many
from ..curve.vesta import PointBatch
from .mesh import Mesh


def _combine(mesh: Mesh, partial: PointBatch) -> PointBatch:
    """Σ over ranks of each rank's `partial`, on every rank."""
    coords = torch.stack(list(partial), dim=1)  # (16, 3, *batch)
    allp = mesh.all_gather(coords[None], 0)  # (D, 16, 3, *batch)
    acc = vesta.identity(partial.batch_shape, partial.x.device)
    for i in range(mesh.size):
        acc = padd(acc, PointBatch(*allp[i].unbind(1)))
    return acc


def msm_sharded(mesh: Mesh, scalars_plain: torch.Tensor,
                points: PointBatch) -> PointBatch:
    """Σ s_i·P_i over all ranks' blocks: this rank's scalars (16, N/D) and
    points (batch (N/D,)), affine-or-identity as `msm` takes them.
    Returns the whole sum (batch ()) on every rank."""
    n = scalars_plain.shape[-1]
    return _combine(mesh, msm(scalars_plain, points,
                              window_bits=choose_window_bits(n)))


def msm_many_sharded(mesh: Mesh, scalars_plain: torch.Tensor,
                     points: PointBatch) -> PointBatch:
    """Batched MSM of (16, B, N/D) scalar vectors against this rank's
    block of points; returns the B whole sums (batch (B,)) on every rank."""
    n = scalars_plain.shape[-1]
    return _combine(mesh, msm_many(scalars_plain, points,
                                   window_bits=choose_window_bits(n)))
