"""Kernels B3-B6: fused complete Vesta point operations.

Replace the Pallas kernels of `tinyram_tpu/curve/pallas_point.py`:

  B3 `padd_select_mixed` (`_madd_select_call`): select(mask, acc + (qx, qy, 1),
     (qx, qy, 1)), RCB16 Algorithm 8 — the MSM bucket scan's step;
  B4 `padd` (`_padd_call`): complete add, RCB16 Algorithm 7;
  B5 `padd_select` (`_padd_select_call`): select(mask, p + q, q);
  B6 `pdouble` (`_pdouble_call`): doubling, RCB16 Algorithm 9.

Each wrapper takes `(16, *batch)` int32 Fq limb tensors (Montgomery form)
and a bool mask shaped like the batch.  A CUDA tensor goes to its kernel in
`csrc/point.cu`, a CPU tensor to its plain version: the level-batched formula of
`vesta.py` over `FQ_PLAIN` (same limbs: every field op is canonical),
with the selects computing their sums on the selected lanes only.

Source note (the kernels, over `csrc/field.cuh`): one thread per lane
gathers the coordinates (limb i of lane j at i·n + j, coalesced), packs
each into 8 32-bit words held in registers, runs the RCB16 formula of
`tinyram_tpu/curve/vesta.py` step for step with the field.cuh Montgomery
multiply, add and subtract, selects, and unpacks.  A complete add is 12
products (~1,000 32-bit multiply-adds) against 9 × 64 B of device traffic,
so these kernels should be bound by the integer multiply rate and by
register pressure (the live set is a dozen 8-word values).  `-Xptxas -v`
at build time (CUDA 12.8, sm_90a) reports 108 registers for B3, 142 for B4,
144 for B5 and 94 for B6, and no spills; at 128 threads a block that allows
three or four blocks per SM.  One lane per thread keeps the code a
transcription of the formulas; spreading a lane over several threads is
later work.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field.field import FQ_PLAIN
from ..field.params import N_LIMBS
from . import vesta
from .vesta import PointBatch


def _flat(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.reshape(N_LIMBS, n).contiguous()


def _lanes(batch_shape) -> int:
    n = 1
    for d in batch_shape:
        n *= d
    return n


def _check(tensors, device):
    for t in tensors:
        if t.dtype != torch.int32 or t.device != device:
            raise ValueError("point kernels take int32 limbs on one device")


def _launch(name, wrapper, mask, ins, batch_shape):
    """Flatten, allocate the three outputs, launch `name`, unflatten."""
    device = ins[0].device
    _check(ins, device)
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    n = _lanes(batch_shape)
    flats = [_flat(t, n) for t in ins]
    outs = [torch.empty((N_LIMBS, n), dtype=torch.int32, device=device)
            for _ in range(3)]
    if n == 0:
        return PointBatch(*(o.reshape((N_LIMBS,) + batch_shape) for o in outs))
    args = []
    if mask is not None:
        m = mask.reshape(n).to(device=device, dtype=torch.uint8).contiguous()
        args.append(m.data_ptr())
    args += [t.data_ptr() for t in flats] + [o.data_ptr() for o in outs]
    lib = kernels.library()
    wrapper.launches += 1
    kernels.check(
        getattr(lib, name)(*args, n, kernels.stream_ptr(device)), name
    )
    return PointBatch(*(o.reshape((N_LIMBS,) + batch_shape) for o in outs))


# ---------------------------------------------------------------- plain


def _masked(mask, base: PointBatch, fn) -> PointBatch:
    """`base` with the lanes where mask holds replaced by fn(lane index):
    the plain selects compute their sums on the selected lanes only."""
    shape = base.x.shape
    n = _lanes(shape[1:])
    out = [c.reshape(N_LIMBS, n).clone() for c in base]
    idx = mask.reshape(n).nonzero().squeeze(1)
    if idx.numel():
        for o, v in zip(out, fn(idx)):
            o[:, idx] = v
    return PointBatch(*(o.reshape(shape) for o in out))


def _take(p: PointBatch, idx, n: int) -> PointBatch:
    return PointBatch(*(c.reshape(N_LIMBS, n)[:, idx] for c in p))


def madd_select_plain(mask, acc: PointBatch, qx, qy) -> PointBatch:
    n = _lanes(qx.shape[1:])
    lifted = PointBatch(qx, qy, FQ_PLAIN.ones(qx.shape[1:], qx.device))
    return _masked(mask, lifted, lambda idx: vesta.add_mixed(
        _take(acc, idx, n), qx.reshape(N_LIMBS, n)[:, idx],
        qy.reshape(N_LIMBS, n)[:, idx], FQ_PLAIN))


def padd_plain(p: PointBatch, q: PointBatch) -> PointBatch:
    return vesta.add(p, q, FQ_PLAIN)


def padd_select_plain(mask, p: PointBatch, q: PointBatch) -> PointBatch:
    n = _lanes(q.x.shape[1:])
    return _masked(mask, q, lambda idx: vesta.add(
        _take(p, idx, n), _take(q, idx, n), FQ_PLAIN))


def pdouble_plain(p: PointBatch) -> PointBatch:
    return vesta.double(p, FQ_PLAIN)


# -------------------------------------------------------------- wrappers


def padd_select_mixed(mask, acc: PointBatch, qx, qy) -> PointBatch:
    """B3: select(mask, acc + (qx, qy, 1), (qx, qy, 1)); q finite."""
    if qx.device.type == "cpu":
        return madd_select_plain(mask, acc, qx, qy)
    return _launch("tr_madd_select", padd_select_mixed, mask,
                   [acc.x, acc.y, acc.z, qx, qy], tuple(qx.shape[1:]))


def padd(p: PointBatch, q: PointBatch) -> PointBatch:
    """B4: complete projective add."""
    if p.x.device.type == "cpu":
        return padd_plain(p, q)
    return _launch("tr_padd", padd, None, [*p, *q], tuple(p.x.shape[1:]))


def padd_select(mask, p: PointBatch, q: PointBatch) -> PointBatch:
    """B5: select(mask, p + q, q)."""
    if p.x.device.type == "cpu":
        return padd_select_plain(mask, p, q)
    return _launch("tr_padd_select", padd_select, mask, [*p, *q],
                   tuple(p.x.shape[1:]))


def pdouble(p: PointBatch) -> PointBatch:
    """B6: exception-free doubling."""
    if p.x.device.type == "cpu":
        return pdouble_plain(p)
    return _launch("tr_pdouble", pdouble, None, [*p], tuple(p.x.shape[1:]))


for _id, _w in (("B3", padd_select_mixed), ("B4", padd), ("B5", padd_select),
               ("B6", pdouble)):
    kernels.register(_id, _w)
