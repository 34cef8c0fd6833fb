"""Kernels B3-B6: fused complete Vesta point operations.

Replace the Pallas kernels of `tinyram_tpu/curve/pallas_point.py`:

  B3 `padd_select_mixed` (`_madd_select_call`): select(mask, acc + (qx, qy, 1),
     (qx, qy, 1)), RCB16 Algorithm 8 — the MSM bucket scan's step;
  B4 `padd` (`_padd_call`): complete add, RCB16 Algorithm 7;
  B5 `padd_select` (`_padd_select_call`): select(mask, p + q, q);
  B6 `pdouble` (`_pdouble_call`): doubling, RCB16 Algorithm 9, `times` of
     them in one launch (the MSM's doubling chains).

and four forms that run a loop of `tinyram_tpu/curve/msm.py` inside one
launch: the bucket scan's `lax.scan` (412-419), the bit-serial ladder's
(693-698 and 714-718), the weighted reduce's suffix scan (524-534) and the
window combine's `fori_loop` (600-621):

  B3s `padd_select_mixed_scan`: L steps of B3 from the identity, every
      step's accumulator returned;
  B5l `padd_select_ladder`: R steps of acc = 2·acc (B6's Algorithm 9), then
      acc = select(bit, p + acc, acc) (B5's Algorithm 7), from the identity;
  B4s `padd_suffix_scan`: S steps over the last batch axis, from the last
      down: acc = acc + b_j, then tot = acc + tot for j >= 1 (two B4 adds);
  B6h `pdouble_horner`: Horner over the windows, c doublings and one add
      per window.

Each wrapper takes `(16, *batch)` int32 Fq limb tensors (Montgomery form)
and, for the selects, a bool mask shaped like the batch.  A CUDA tensor
goes to its kernel in `csrc/point.cu`, a CPU tensor to its plain version:
the level-batched formula of `vesta.py` over `FQ_PLAIN` (same limbs: every
field op is canonical), with the selects computing their sums on the
selected lanes only; the forms' plain versions (and B6's with a count) are
the Python loops over the one-step ones.

Source note (the kernels, over `csrc/field.cuh`).  A complete add is 12
Montgomery products against 9 × 64 B of device traffic, so the kernels are
bound by the integer pipes once more than a few lanes in a warp add.  Every
kernel runs the carry-chain field functions (PTX add.cc/madc, p's zero
words skipped) and runs each formula as stages of independent products.
Where the lanes are many (every kernel but B6h) a thread holds one lane and
a stage's products run in a loop that is not unrolled: the code holds one
product per stage, and the ladder, unrolled, was three times as long and
1.5 times as slow.  The forms keep the accumulator in registers across
steps: the scan stages each step's q into shared memory by cp.async while
the previous step computes, the ladder reads its point once, the suffix
scan reads each bucket once (a tiled transpose in the same entry point
first lays the buckets out step-major, so that a warp's loads of one step
are contiguous: torch's own permute copy took 8 of a 13.5 ms call), and
B6 with a count and B6h read their point or window sum once.  So each of
the MSM's sequential loops costs one launch, not one per step, and no
step sends the accumulator through device memory.  What bounds the wide
kernels is the dependent carry chain of one product per thread: at 2^15
lanes a scheduler holds two warps.  The window combine runs on 4-64 lanes
(one per MSM column), so there the card waits on each lane's chain of
2,320 dependent products: B6h spreads each stage's products over a group
of `HORNER_GROUP` threads per lane that exchange them by warp shuffles,
which cuts the chain to 600 products (2.95 times faster than one thread
per lane on an H100; `group=1` is kept to measure one product's latency).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..field.field import FQ_PLAIN
from ..field.params import N_LIMBS
from . import vesta
from .vesta import PointBatch

HORNER_GROUP = 4  # threads per lane of B6h (1 or 4; see PERF.md)


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
    if device.type != "cuda":
        raise ValueError(f"point kernels: unsupported device {device}")


def _u8(mask: torch.Tensor, n: int, device) -> torch.Tensor:
    return mask.reshape(n).to(device=device, dtype=torch.uint8).contiguous()


def _run(name, wrapper, device, tensors, *sizes):
    """Launch `name` on `tensors` (None passes a null pointer); the list
    keeps any temporary copies alive until the launch is issued.  The last
    of `sizes` is the lane count."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    lib = kernels.library()
    wrapper.launches += 1
    kernels.check(
        getattr(lib, name)(*ptrs, *sizes, kernels.stream_ptr(device)), name
    )


def _launch(name, wrapper, mask, ins, batch_shape, *sizes):
    """Flatten, allocate the three outputs, launch `name` (with `sizes`
    before the lane count), unflatten."""
    device = ins[0].device
    _check(ins, device)
    n = _lanes(batch_shape)
    outs = [torch.empty((N_LIMBS, n), dtype=torch.int32, device=device)
            for _ in range(3)]
    if n:
        ts = [] if mask is None else [_u8(mask, n, device)]
        ts += [_flat(t, n) for t in ins] + outs
        _run(name, wrapper, device, ts, *sizes, n)
    return PointBatch(*(o.reshape((N_LIMBS,) + batch_shape) for o in outs))


def _scan(wrapper, same, acc, sx, sy) -> PointBatch:
    """tr_madd_select_scan over (L, M) masks and (L, 16, M) points, from
    `acc` (batch (M,)) or, when it is None, the identity."""
    device = sx.device
    _check([sx, sy] + ([] if acc is None else list(acc)), device)
    L, M = same.shape
    outs = [torch.empty((L, N_LIMBS, M), dtype=torch.int32, device=device)
            for _ in range(3)]
    if L * M:
        ts = [_u8(same, L * M, device)]
        ts += [None] * 3 if acc is None else [_flat(c, M) for c in acc]
        ts += [t.reshape(L, N_LIMBS, M).contiguous() for t in (sx, sy)]
        _run("tr_madd_select_scan", wrapper, device, ts + outs, L, M)
    return PointBatch(*outs)


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


def pdouble_plain(p: PointBatch, times: int = 1) -> PointBatch:
    """B6's plain version: the loop of `times` doublings."""
    for _ in range(times):
        p = vesta.double(p, FQ_PLAIN)
    return p


def madd_select_scan_plain(same, sx, sy) -> PointBatch:
    """B3s's plain version: the loop of `madd_select_plain` steps."""
    L, _, M = sx.shape
    ys = [torch.empty((L, N_LIMBS, M), dtype=torch.int32, device=sx.device)
          for _ in range(3)]
    acc = vesta.identity((M,), sx.device)
    for s in range(L):
        acc = madd_select_plain(same[s], acc, sx[s], sy[s])
        for coord, val in zip(ys, acc):
            coord[s] = val
    return PointBatch(*ys)


def suffix_scan_plain(b: PointBatch):
    """B4s's plain version: the loop of `padd_plain` steps."""
    batch = tuple(b.x.shape[1:-1])
    acc = vesta.identity(batch, b.x.device)
    tot = vesta.identity(batch, b.x.device)
    for j in range(b.x.shape[-1] - 1, -1, -1):
        acc = padd_plain(acc, PointBatch(*(c[..., j] for c in b)))
        if j >= 1:
            tot = padd_plain(acc, tot)
    return acc, tot


def horner_plain(window_sums: PointBatch, c: int) -> PointBatch:
    """B6h's plain version: the loop of `pdouble_plain` and `padd_plain`
    steps."""
    acc = vesta.identity(tuple(window_sums.x.shape[2:]), window_sums.x.device)
    for w in range(window_sums.x.shape[1] - 1, -1, -1):
        acc = padd_plain(pdouble_plain(acc, c),
                         PointBatch(*(coord[:, w] for coord in window_sums)))
    return acc


def ladder_plain(bits, p: PointBatch) -> PointBatch:
    """B5l's plain version: the loop of `pdouble_plain` and
    `padd_select_plain` steps."""
    acc = vesta.identity(tuple(bits.shape[1:]), p.x.device)
    for bit in bits:
        acc = padd_select_plain(bit, p, pdouble_plain(acc))
    return acc


# -------------------------------------------------------------- wrappers


def padd_select_mixed(mask, acc: PointBatch, qx, qy) -> PointBatch:
    """B3: select(mask, acc + (qx, qy, 1), (qx, qy, 1)); q finite.  On the
    card, B3s's kernel with one step from `acc`."""
    if qx.device.type == "cpu":
        return madd_select_plain(mask, acc, qx, qy)
    batch = tuple(qx.shape[1:])
    n = _lanes(batch)
    ys = _scan(padd_select_mixed, mask.reshape(1, n), acc,
               qx.reshape(1, N_LIMBS, n), qy.reshape(1, N_LIMBS, n))
    return PointBatch(*(y.reshape((N_LIMBS,) + batch) for y in ys))


def padd_select_mixed_scan(same, sx, sy) -> PointBatch:
    """B3s: acc = identity; for s < L: acc = B3(same[s], acc, sx[s], sy[s]),
    ys[s] = acc.  same (L, M) bool, sx and sy (L, 16, M) affine and finite;
    returns ys as three (L, 16, M) tensors."""
    if sx.device.type == "cpu":
        return madd_select_scan_plain(same, sx, sy)
    return _scan(padd_select_mixed_scan, same, None, sx, sy)


def padd(p: PointBatch, q: PointBatch) -> PointBatch:
    """B4: complete projective add."""
    if p.x.device.type == "cpu":
        return padd_plain(p, q)
    return _launch("tr_padd", padd, None, [*p, *q], tuple(p.x.shape[1:]))


def padd_suffix_scan(b: PointBatch):
    """B4s: acc = tot = identity; for j = S-1 .. 0: acc = B4(acc, b[..., j]),
    then, for j >= 1, tot = B4(acc, tot).  b has batch (*lanes, S); returns
    (acc, tot), each of batch `lanes`: acc = Σ_j b_j, tot = Σ_j j·b_j."""
    if b.x.device.type == "cpu":
        return suffix_scan_plain(b)
    device = b.x.device
    _check(list(b), device)
    *batch, S = b.x.shape[1:]
    batch = tuple(batch)
    n = _lanes(batch)
    outs = [torch.empty((N_LIMBS, n), dtype=torch.int32, device=device)
            for _ in range(6)]
    if n:
        # the kernel reads (16, n / H, H, S) views whose lanes hold their
        # steps contiguously (the msm's buckets, without a copy)
        H = batch[-1] if batch else 1
        ts = [c.reshape(N_LIMBS, n // H, H, S) for c in b]
        if any(t.stride() != ts[0].stride() or t.stride(3) != 1
               or t.stride(2) != S for t in ts):
            ts = [t.contiguous() for t in ts]
        scratch = torch.empty((3, S, N_LIMBS, n), dtype=torch.int32,
                              device=device)
        _run("tr_padd_suffix_scan", padd_suffix_scan, device,
             ts + [scratch] + outs, S, H, ts[0].stride(0), ts[0].stride(1), n)
    acc, tot = (PointBatch(*(o.reshape((N_LIMBS,) + batch) for o in part))
                for part in (outs[:3], outs[3:]))
    return acc, tot


def padd_select(mask, p: PointBatch, q: PointBatch) -> PointBatch:
    """B5: select(mask, p + q, q)."""
    if p.x.device.type == "cpu":
        return padd_select_plain(mask, p, q)
    return _launch("tr_padd_select", padd_select, mask, [*p, *q],
                   tuple(p.x.shape[1:]))


def padd_select_ladder(bits, p: PointBatch) -> PointBatch:
    """B5l: acc = identity; for r < R: acc = B5(bits[r], p, B6(acc)).
    bits (R, *batch) bool, p batch `batch`; returns acc."""
    if p.x.device.type == "cpu":
        return ladder_plain(bits, p)
    R = bits.shape[0]
    batch = tuple(bits.shape[1:])
    n = _lanes(batch)
    device = p.x.device
    _check(list(p), device)
    if R == 0:
        return vesta.identity(batch, device)
    outs = [torch.empty((N_LIMBS, n), dtype=torch.int32, device=device)
            for _ in range(3)]
    if n:
        ts = [_u8(bits, R * n, device)] + [_flat(c, n) for c in p] + outs
        _run("tr_padd_select_ladder", padd_select_ladder, device, ts, R, n)
    return PointBatch(*(o.reshape((N_LIMBS,) + batch) for o in outs))


def pdouble(p: PointBatch, times: int = 1) -> PointBatch:
    """B6: `times` exception-free doublings in one launch."""
    if p.x.device.type == "cpu":
        return pdouble_plain(p, times)
    if times == 0:
        return p
    return _launch("tr_pdouble", pdouble, None, [*p], tuple(p.x.shape[1:]),
                   times)


def pdouble_horner(window_sums: PointBatch, c: int,
                   group: int = HORNER_GROUP) -> PointBatch:
    """B6h: Σ_w 2^{cw} S_w by Horner, acc = identity; for w = nw-1 .. 0:
    acc = B4(B6(acc, times=c), S_w).  window_sums has batch (nw, *rest);
    returns batch `rest`.  `group` threads run each lane (1 or 4)."""
    if window_sums.x.device.type == "cpu":
        return horner_plain(window_sums, c)
    device = window_sums.x.device
    _check(list(window_sums), device)
    nw = window_sums.x.shape[1]
    batch = tuple(window_sums.x.shape[2:])
    n = _lanes(batch)
    outs = [torch.empty((N_LIMBS, n), dtype=torch.int32, device=device)
            for _ in range(3)]
    if n:
        ts = [s.reshape(N_LIMBS, nw, n).contiguous() for s in window_sums]
        _run("tr_pdouble_horner", pdouble_horner, device, ts + outs, c, nw,
             group, n)
    return PointBatch(*(o.reshape((N_LIMBS,) + batch) for o in outs))


for _id, _w in (("B3", padd_select_mixed), ("B3s", padd_select_mixed_scan),
                ("B4", padd), ("B4s", padd_suffix_scan), ("B5", padd_select),
                ("B5l", padd_select_ladder), ("B6", pdouble),
                ("B6h", pdouble_horner)):
    kernels.register(_id, _w)
