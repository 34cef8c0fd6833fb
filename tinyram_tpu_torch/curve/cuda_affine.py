"""Kernels A1 and A2: the batched-affine bucket scan of the MSM, and the
batched inverse over Fq.

New device code: the JAX package computes both in XLA, with no Pallas
kernel: A1 is the affine `lax.scan` of `_group_bucket_sums_inner`
(`tinyram_tpu/curve/msm.py:351-408`, opted in by `TINYRAM_MSM_AFFINE=1`),
A2 its `batch_inv` (`:239`).

  A1 `affine_scan(same, sx, sy)`: from the identity, L steps of the
     λ-based affine add with its restart, doubling and cancel cases over M
     lanes (same (L, M) bool, sx and sy (L, 16, M)); returns every step's
     accumulator as (L, 16, M) x and y and (L, M) inf;
  A2 `batch_inverse(d, stop_width=256)`: d^-1 lane by lane over (16, n),
     with the reference's result on zero lanes (every lane of a zero's
     stop-level node of the product tree is zero).

A CUDA tensor goes to its kernel in `csrc/affine.cu`, a CPU tensor to the
plain version in `msm.py` (`affine_scan_plain`, `batch_inv`).

Source note (the kernels, over `csrc/field.cuh`'s carry-chain functions).
A1 keeps the accumulator (x, y, inf) of two lanes per thread in registers
across all L steps, one launch per scan as B3s.  Per step each block of
256 threads inverts its 512 lanes' denominators by Montgomery's trick: the
two lanes' product, a product scan up and one down the block in shared
memory (8 levels each), one Fermat inversion of the block's product by
thread 0, and three products back.  An inverse is unique, so this equals
the reference's one inversion over all M lanes limb for limb; the lanes
that add nothing carry one, as there.  A step is ~7 + 2·8 products per
lane against 2 × 64 B read and 2 × 64 B + 1 B written, so the lanes'
work is bound by the integer multiply pipe; but the step's latency is the
Fermat chain, 255 squarings and 127 products, each dependent on the one
before (~0.21 ms at B6h's measured product latency), while the block
waits at its barrier.  So the kernel is bound by that chain times L, not
by bytes or operations: the simple design pays it once per block and
step, and a shorter chain (a binary extended GCD) or more lanes per
inversion is what would move it.  A2 is the same block inversion once,
over groups of 2^k lanes (k the product tree's depth at `stop_width`),
each thread running its consecutive lanes' products serially.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field.params import N_LIMBS

STOP_WIDTH = 256  # the reference's `batch_inv` default


def _check(tensors, device):
    for t in tensors:
        if t.dtype != torch.int32 or t.device != device:
            raise ValueError("affine kernels take int32 limbs on one device")
    if device.type != "cuda":
        raise ValueError(f"affine kernels: unsupported device {device}")


def group_log2(n: int, stop_width: int = STOP_WIDTH) -> int:
    """Depth of `batch_inv`'s product tree over n lanes: its stop-level
    nodes are the groups of 2^depth consecutive lanes."""
    depth = 0
    while n > stop_width:
        n = (n + 1) // 2
        depth += 1
    return depth


def affine_scan(same, sx, sy):
    """A1: acc = (0, 0, inf); for s < L: acc = step(same[s], acc, sx[s],
    sy[s]), out[s] = acc (`msm.affine_step`).  Returns (x, y, inf)."""
    if sx.device.type == "cpu":
        from .msm import affine_scan_plain

        return affine_scan_plain(same, sx, sy)
    device = sx.device
    _check([sx, sy], device)
    L, M = same.shape
    if sx.shape != (L, N_LIMBS, M) or sy.shape != sx.shape:
        raise ValueError(f"affine_scan: shapes {tuple(same.shape)} "
                         f"{tuple(sx.shape)} {tuple(sy.shape)}")
    ox = torch.empty((L, N_LIMBS, M), dtype=torch.int32, device=device)
    oy = torch.empty_like(ox)
    oinf = torch.empty((L, M), dtype=torch.uint8, device=device)
    if L * M:
        ts = [same.to(device=device, dtype=torch.uint8).contiguous(),
              sx.contiguous(), sy.contiguous()]
        lib = kernels.library()
        affine_scan.launches += 1
        kernels.check(
            lib.tr_affine_scan(*(t.data_ptr() for t in ts), ox.data_ptr(),
                               oy.data_ptr(), oinf.data_ptr(), L, M,
                               kernels.stream_ptr(device)),
            "tr_affine_scan")
    return ox, oy, oinf.to(torch.bool)


def batch_inverse(d, stop_width: int = STOP_WIDTH):
    """A2: inverses of d (16, n) over its last axis, as `msm.batch_inv`."""
    if d.dim() != 2 or d.shape[0] != N_LIMBS:
        raise ValueError(f"batch_inverse: bad input {tuple(d.shape)}")
    if d.device.type == "cpu":
        from .msm import batch_inv

        return batch_inv(d, stop_width)
    _check([d], d.device)
    d = d.contiguous()
    out = torch.empty_like(d)
    n = d.shape[1]
    if n:
        lib = kernels.library()
        batch_inverse.launches += 1
        kernels.check(
            lib.tr_batch_inv(d.data_ptr(), out.data_ptr(), n,
                             group_log2(n, stop_width),
                             kernels.stream_ptr(d.device)),
            "tr_batch_inv")
    return out


kernels.register("A1", affine_scan)
kernels.register("A2", batch_inverse)
