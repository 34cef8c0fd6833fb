"""Pippenger multi-scalar multiplication (PyTorch; kernels B3-B6 and their
loop forms).

Port of `tinyram_tpu/curve/msm.py`, same algorithm:

  1. signed c-bit digits straight from the 16-bit limbs (bucket = |d|, the
     point is negated when d < 0);
  2. points digit-sorted per window, then bucket sums by a chunked
     segmented scan: the sorted lane axis is cut into chunks of length L and
     one launch of kernel B3s (L steps of the mixed add-select B3) computes
     within-chunk segmented inclusive sums at full lane width;
  3. a log-width carry fixup (kernel B5) stitches segments that span chunk
     boundaries, and kernel B4 adds each chunk's incoming carry;
  4. segment-end rows land in their buckets (exactly one row per bucket);
  5. the bucket-weighted reduction Σ d·B_d splits d = hi·S + lo: a serial
     suffix scan over lo (one launch of kernel B4s, two adds per step),
     log-depth combines over hi (B4) and the doubling chains (one launch
     of B6 with a count each);
  6. Horner over the windows, c doublings and one add per window (one
     launch of kernel B6h).

Up to 2^15 lanes a bit-serial double-and-add replaces it: one launch of
kernel B5l (B6 then B5 per bit).  The reference's sequential loops (the
bucket scan, the ladder, the suffix scan, the window combine's
`fori_loop` and the doubling chains) run inside those kernels; the
log-depth trees and the carry fixup are Python loops of one-step launches
(B4, B5), one per level.  The reference's environment knobs
are keyword arguments with the same defaults (`window_bits`, `group_log2`,
`lanes_log2`), and so is its `TINYRAM_DEBUG` check of the affine-input
precondition (`check_affine`).

`affine=True` (the reference's `TINYRAM_MSM_AFFINE=1`) replaces the bucket
scan of step 2 with the batched-affine scan: the accumulator stays affine
(x, y, inf) and each step's λ denominators of all lanes share one
inversion (Montgomery's trick), one launch of kernel A1 per scan
(`cuda_affine.py`); its plain version is `affine_scan_plain` below, over
`batch_inv`.  The scan's rows are lifted back to projective (z = 0 for the
identity, one otherwise) and steps 3-6 are unchanged.  It defaults to
2^17 lanes per scan step, where the projective scan takes 2^15.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..field.field import FQ, FQ_PLAIN
from ..field.params import N_LIMBS
from . import vesta
from .cuda_affine import STOP_WIDTH, affine_scan
from .cuda_point import (padd, padd_select, padd_select_ladder,
                         padd_select_mixed_scan, padd_suffix_scan, pdouble,
                         pdouble_horner)
from .vesta import PointBatch

SCALAR_BITS = 16 * N_LIMBS  # 256
GROUP_LOG2 = 22  # peak elements per window group (reference default)
LANES_LOG2 = 15  # total lanes per scan step (reference default)
AFFINE_LANES_LOG2 = 17  # ... of the affine scan, whose steps cost more
SMALL_MSM_LANES = 1 << 15  # bit-serial path up to this many lanes


def choose_window_bits(n: int) -> int:
    """Minimize W(c)·(n + 0.4·2^(c-1)) (the reference's cost model)."""
    best_c, best_cost = 8, None
    c_max = min(17, max(8, n.bit_length() - 2))
    for c in range(6, c_max + 1):
        w = -(-SCALAR_BITS // c)
        cost = w * (n + 0.4 * (1 << (c - 1)))
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def scalar_digits(scalars_plain: torch.Tensor, c: int) -> torch.Tensor:
    """(16, ...) plain (non-Montgomery) scalar limbs -> (W, ...) int64
    digits; window w covers scalar bits [w·c, w·c + c)."""
    n_windows = -(-SCALAR_BITS // c)
    mask = (1 << c) - 1
    s64 = scalars_plain.to(torch.int64)
    outs = []
    for w in range(n_windows):
        lo_bit = w * c
        i0, s = divmod(lo_bit, 16)
        if i0 >= N_LIMBS:
            outs.append(torch.zeros_like(s64[0]))
            continue
        d = s64[i0] >> s
        if s + c > 16 and i0 + 1 < N_LIMBS:
            d = d | (s64[i0 + 1] << (16 - s))
        if s + c > 32 and i0 + 2 < N_LIMBS:
            d = d | (s64[i0 + 2] << (32 - s))
        outs.append(d & mask)
    return torch.stack(outs)


def signed_digits(scalars_plain: torch.Tensor, c: int):
    """(16, ...) plain scalars -> (|d|, sign) with d in [-2^(c-1), 2^(c-1)].

    d'_w = d_w + carry; above 2^(c-1) subtract 2^c and carry 1 into window
    w+1.  The top window never overflows: scalars are < p < 2^255.
    """
    d = scalar_digits(scalars_plain, c)
    half = 1 << (c - 1)
    full = 1 << c
    carry = torch.zeros_like(d[0])
    out = torch.empty_like(d)
    for w in range(d.shape[0]):
        dw = d[w] + carry
        hi = dw > half
        out[w] = torch.where(hi, dw - full, dw)
        carry = hi.to(d.dtype)
    return out.abs(), out < 0


@lru_cache(maxsize=None)
def plan(n: int, n_windows: int, group_log2: int = GROUP_LOG2,
         lanes_log2: int = LANES_LOG2):
    """(group size G, lanes per window, chunk length L, padded N)."""
    group_elems, target_lanes = 1 << group_log2, 1 << lanes_log2
    g = max(1, min(n_windows, group_elems // max(n, 1)))
    k_per_window = max(1, target_lanes // g)
    cap = min(k_per_window, max(1, n // 8))
    if cap >= 128:
        lanes = (cap // 128) * 128
    else:
        lanes = 1
        while lanes * 2 <= cap:
            lanes *= 2
    n_pad = -(-n // lanes) * lanes
    L = n_pad // lanes
    return g, lanes, L, n_pad


def _lanes_log2(lanes_log2: int | None, affine: bool) -> int:
    """The reference's `_target_lanes`: 2^17 for the affine scan."""
    if lanes_log2 is not None:
        return lanes_log2
    return AFFINE_LANES_LOG2 if affine else LANES_LOG2


def _fermat_unrolled(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) over Fq by square and multiply over the bits of p - 2, from
    the top (the reference's ladder, without its unrolling): the inverse,
    and inv(0) = 0.  Plain products (`FQ_PLAIN`)."""
    return FQ_PLAIN.pow_const(a, FQ.modulus - 2)


def batch_inv(d: torch.Tensor, stop_width: int = STOP_WIDTH) -> torch.Tensor:
    """Inverses over the last axis by a product tree (plain version of
    kernel A2).

    Montgomery's simultaneous inversion as the reference runs it: pair
    neighbours up (an odd level is padded with one) until at most
    `stop_width` products are left, invert those by `_fermat_unrolled`,
    then go down (inv_left = inv_parent·right, inv_right =
    inv_parent·left).  A zero input makes its whole node at the stop level
    zero: the callers substitute one for zeros first.
    """
    levels = []  # (left, right, width before padding)
    cur = d
    while cur.shape[-1] > stop_width:
        n = cur.shape[-1]
        if n % 2:
            cur = torch.cat(
                [cur, FQ_PLAIN.ones(cur.shape[1:-1] + (1,), cur.device)],
                dim=-1)
        left, right = cur[..., 0::2], cur[..., 1::2]
        levels.append((left, right, n))
        cur = FQ_PLAIN.mul(left, right)
    inv = _fermat_unrolled(cur)
    for left, right, n in reversed(levels):
        inv_left = FQ_PLAIN.mul(inv, right)
        inv_right = FQ_PLAIN.mul(inv, left)
        w = left.shape[-1]
        inv = torch.stack([inv_left, inv_right], dim=-1).reshape(
            left.shape[:-1] + (2 * w,))[..., :n]
    return inv


def affine_step(acc, s, cx, cy):
    """One step of the batched-affine bucket scan (plain products), the
    reference's scan body.  acc = (ax, ay, inf) over M lanes, s the (M,)
    `same` mask, (cx, cy) the step's affine points; returns the new
    accumulator.  Cases: restart (not s) or identity accumulator -> take q;
    x equal and y equal -> doubling (λ = 3x²/2y); x equal, y differs ->
    cancel to the identity, canonical (0, 1); else the chord
    (λ = Δy/Δx).  The denominators of lanes that add nothing, and zero
    ones, are replaced by one before the shared inversion."""
    F = FQ_PLAIN
    ax, ay, inf = acc
    M = s.shape[0]
    one_m = F.ones((M,), cx.device)
    x_eq = F.eq(ax, cx)
    y_eq = F.eq(ay, cy)
    dbl = x_eq & y_eq
    cancel = x_eq & ~y_eq
    ax2 = F.mul(ax, ax)
    numer = F.select(dbl, F.add(F.double(ax2), ax2), F.sub(cy, ay))
    denom = F.select(dbl, F.double(ay), F.sub(cx, ax))
    active = s & ~inf & ~cancel
    safe = active & ~F.is_zero(denom)
    denom = F.select(safe, denom, one_m)
    lam = F.mul(numer, batch_inv(denom))
    x3 = F.sub(F.sub(F.mul(lam, lam), ax), cx)
    y3 = F.sub(F.mul(lam, F.sub(ax, x3)), ay)
    takes_q = ~s | inf
    nx = F.select(takes_q, cx, x3)
    ny = F.select(takes_q, cy, y3)
    ninf = s & ~inf & cancel
    nx = F.select(ninf, F.zeros((M,), cx.device), nx)
    ny = F.select(ninf, one_m, ny)
    return nx, ny, ninf


def affine_scan_plain(same, sx, sy):
    """A1's plain version: from (0, 0, inf) the loop of `affine_step` over
    same (L, M) and sx, sy (L, 16, M); returns every step's accumulator as
    (L, 16, M) x and y and (L, M) inf."""
    L, _, M = sx.shape
    dev = sx.device
    xs = torch.empty((L, N_LIMBS, M), dtype=torch.int32, device=dev)
    ys = torch.empty_like(xs)
    infs = torch.empty((L, M), dtype=torch.bool, device=dev)
    acc = (FQ.zeros((M,), dev), FQ.zeros((M,), dev),
           torch.ones((M,), dtype=torch.bool, device=dev))
    for s in range(L):
        acc = affine_step(acc, same[s], sx[s], sy[s])
        xs[s], ys[s], infs[s] = acc
    return xs, ys, infs


def _shift_lanes(p: PointBatch, d: int, fill: PointBatch) -> PointBatch:
    """Lane k takes lane k-d (the first d lanes take `fill`)."""
    return PointBatch(*(
        torch.cat([f[..., :d], c[..., :-d]], dim=-1) for c, f in zip(p, fill)
    ))


def _group_bucket_sums(
    digits_g: torch.Tensor,  # (G, N) bucket ids (|d| for signed)
    signs_g: torch.Tensor,  # (G, N) bool: negate the point in this window
    points: PointBatch,  # batch (N,)
    lanes_per_window: int,
    L: int,
    n_buckets: int,
    affine: bool = False,
) -> PointBatch:
    """Bucket sums for G digit vectors at once -> batch (G, n_buckets + 1).

    Slot n_buckets is the spill bucket (identity inputs and padding): the
    projective scan leaves the identity there, the affine one what its
    padding lanes sum to, and nothing reads it.  `affine` runs the
    batched-affine scan (A1) in place of the projective one (B3s).
    """
    dev = digits_g.device
    spill = n_buckets
    G, n = digits_g.shape
    n_pad = lanes_per_window * L
    # identity inputs contribute nothing: route them to the spill bucket so
    # the mixed-add scan never sees a non-finite q (RCB16 Alg. 8)
    ident_in = FQ.is_zero(points.z)
    digits_g = torch.where(ident_in[None, :], spill, digits_g)
    px_all, py_all = points.x, points.y
    if n_pad != n:
        digits_g = torch.cat(
            [digits_g, torch.full((G, n_pad - n), spill, dtype=digits_g.dtype,
                                  device=dev)], dim=1)
        signs_g = torch.cat(
            [signs_g, torch.zeros((G, n_pad - n), dtype=torch.bool,
                                  device=dev)], dim=1)
        zero = FQ.zeros((n_pad - n,), dev)
        px_all = torch.cat([px_all, zero], dim=-1)
        py_all = torch.cat([py_all, zero], dim=-1)

    order = torch.argsort(digits_g, dim=-1, stable=True)  # (G, n_pad)
    d_sorted = torch.gather(digits_g, 1, order)
    s_sorted = torch.gather(signs_g, 1, order)
    flat_order = order.reshape(-1)
    px = px_all[:, flat_order].reshape(N_LIMBS, G, n_pad)
    py = py_all[:, flat_order].reshape(N_LIMBS, G, n_pad)
    py = torch.where(s_sorted[None], FQ.neg(py), py)

    # global segment ends (computed before chunking)
    ends = torch.cat(
        [d_sorted[:, 1:] != d_sorted[:, :-1],
         torch.ones((G, 1), dtype=torch.bool, device=dev)], dim=-1)

    M = G * lanes_per_window  # total chunk lanes
    d_chunk = d_sorted.reshape(M, L)
    # scan inputs, step axis first: (L, 16, M)
    sx = px.reshape(N_LIMBS, M, L).permute(2, 0, 1).contiguous()
    sy = py.reshape(N_LIMBS, M, L).permute(2, 0, 1).contiguous()
    same = torch.cat(
        [torch.zeros((M, 1), dtype=torch.bool, device=dev),
         d_chunk[:, 1:] == d_chunk[:, :-1]], dim=-1,
    ).T.contiguous()  # (L, M)

    if affine:
        ax, ay, ainf = affine_scan(same, sx, sy)
        # lift back to projective: z = 0 for identity lanes, one otherwise
        az = torch.where(ainf[:, None, :], torch.zeros((), dtype=torch.int32,
                                                       device=dev),
                         FQ.ones((M,), dev)[None])
        ys = PointBatch(ax, ay, az)
        del ax, ay, ainf
    else:
        ys = padd_select_mixed_scan(same, sx, sy)  # (L, 16, M) each
    del sx, sy

    # ---- cross-chunk carry fixup (log-width over the chunk-lane axis)
    d_first = d_chunk[:, 0]
    d_last = d_chunk[:, -1]
    trailing = PointBatch(*(coord[-1] for coord in ys))  # (16, M)
    window_start = (
        torch.arange(M, device=dev) % lanes_per_window
    ) == 0
    prev = torch.cat([d_last[:1], d_last[:-1]])  # d_last[k-1]
    connects = (d_first == prev) & ~window_start
    allsame_prev = torch.cat(
        [torch.zeros((1,), dtype=torch.bool, device=dev),
         (d_first == d_last)[:-1]])
    ident1 = vesta.identity((M,), dev)
    C = vesta.select(connects, _shift_lanes(trailing, 1, ident1), ident1)
    A = connects & allsame_prev  # propagate flag
    dshift = 1
    while dshift < lanes_per_window:
        Cs = _shift_lanes(C, dshift, ident1)
        As = torch.cat(
            [torch.zeros((dshift,), dtype=torch.bool, device=dev), A[:-dshift]])
        C = padd_select(A, Cs, C)
        A = A & As
        dshift *= 2
    # C[k] = carry into chunk k; it applies at the end of the chunk's first
    # segment (position e = count of leading d_first digits - 1)
    e = (d_chunk == d_first[:, None]).sum(dim=-1) - 1  # (M,)
    lane = torch.arange(M, device=dev)
    at_e = PointBatch(*(coord[e, :, lane].T for coord in ys))  # (16, M)
    fixed = padd(at_e, C)
    for coord, val in zip(ys, fixed):
        coord[e, :, lane] = val.T

    # ---- segment ends into buckets (one contributing row per bucket)
    ids = d_sorted + (
        torch.arange(G, device=dev, dtype=d_sorted.dtype) * (n_buckets + 1)
    )[:, None]
    sel_ids = ids[ends]
    out = []
    for coord in ys:
        flat = coord.permute(1, 2, 0).reshape(N_LIMBS, G * n_pad)
        b = torch.zeros((N_LIMBS, G * (n_buckets + 1)), dtype=torch.int32,
                        device=dev)
        b[:, sel_ids] = flat[:, ends.reshape(-1)]
        out.append(b.reshape(N_LIMBS, G, n_buckets + 1))
    bx, by, bz = out
    empty = (bx == 0).all(0) & (by == 0).all(0) & (bz == 0).all(0)
    by = torch.where(empty[None], FQ.ones((G, n_buckets + 1), dev), by)
    return PointBatch(bx, by, bz)


def _tree_reduce_last(x: PointBatch) -> PointBatch:
    dev = x.x.device
    while x.x.shape[-1] > 1:
        n = x.x.shape[-1]
        if n % 2:
            ident = vesta.identity(x.x.shape[1:-1] + (1,), dev)
            x = PointBatch(*(torch.cat([c, i], dim=-1) for c, i in zip(x, ident)))
            n += 1
        h = n // 2
        x = padd(PointBatch(*(c[..., :h] for c in x)),
                 PointBatch(*(c[..., h:] for c in x)))
    return PointBatch(*(c[..., 0] for c in x))


def _suffix_weighted(T: PointBatch) -> PointBatch:
    """Σ_hi hi·T[..., hi] via log-depth suffix sums then a tree sum."""
    H = T.x.shape[-1]
    ident = vesta.identity(T.x.shape[1:], T.x.device)
    d = 1
    x = T
    while d < H:
        shifted = PointBatch(*(
            torch.cat([c[..., d:], i[..., :d]], dim=-1) for c, i in zip(x, ident)
        ))
        x = padd(x, shifted)
        d *= 2
    # x[..., j] = Σ_{hi≥j} T; Σ_{j≥1} x_j = Σ hi·T_hi
    return _tree_reduce_last(PointBatch(*(c[..., 1:] for c in x)))


def _weighted_bucket_reduce_inner(buckets: PointBatch, c: int) -> PointBatch:
    """Σ_{d=1}^{2^c - 1} d · B_d for all windows at once -> batch (W,)."""
    nw = buckets.x.shape[1]
    n_buckets = 1 << c
    s_lo = c // 2
    S = 1 << s_lo
    H = n_buckets // S
    shape = (N_LIMBS, nw, H, S)
    # serial suffix scan over lo: acc_j = Σ_{lo≥j} B;  U += acc_j for j≥1
    acc, tot = padd_suffix_scan(PointBatch(
        *(coord[..., :n_buckets].reshape(shape) for coord in buckets)))
    X = _suffix_weighted(acc)
    Y = _tree_reduce_last(tot)
    return padd(pdouble(X, times=s_lo), Y)


def _weighted_bucket_reduce_signed(buckets: PointBatch, c: int) -> PointBatch:
    """Σ_{d=1}^{2^(c-1)} d · B_d for signed-digit buckets (batch (W,))."""
    half_bits = c - 1
    half = 1 << half_bits
    main = _weighted_bucket_reduce_inner(buckets, half_bits)
    top = PointBatch(*(coord[..., half] for coord in buckets))
    return padd(main, pdouble(top, times=half_bits))


def _combine_windows(window_sums: PointBatch, c: int) -> PointBatch:
    """Horner: Σ_w 2^{cw} S_w over batch (W, *rest) -> (*rest)."""
    return pdouble_horner(window_sums, c)


def _bucket_sums_all(digits, signs, points: PointBatch, c: int,
                     group_log2: int, lanes_log2: int,
                     affine: bool = False) -> PointBatch:
    """(W_total, N) bucket ids + signs -> batch (W_total, 2^(c-1) + 2)."""
    w_total, n = digits.shape
    n_buckets = (1 << (c - 1)) + 1  # ids 0..2^(c-1); spill index = n_buckets
    G, lanes, L, _ = plan(n, w_total, group_log2, lanes_log2)
    n_groups = -(-w_total // G)
    if n_groups * G != w_total:  # pad with zero digit vectors
        pad = n_groups * G - w_total
        digits = torch.cat([digits, torch.zeros((pad, n), dtype=digits.dtype,
                                                device=digits.device)])
        signs = torch.cat([signs, torch.zeros((pad, n), dtype=torch.bool,
                                              device=signs.device)])
    parts = [
        _group_bucket_sums(digits[g * G:(g + 1) * G], signs[g * G:(g + 1) * G],
                           points, lanes, L, n_buckets, affine)
        for g in range(n_groups)
    ]
    return PointBatch(*(
        torch.cat([p[i] for p in parts], dim=1)[:, :w_total] for i in range(3)
    ))


def _bits_msb_first(scalars_plain: torch.Tensor) -> torch.Tensor:
    """(16, ...) plain limbs -> (256, ...) bool bits, MSB first."""
    rows = []
    for limb in range(N_LIMBS - 1, -1, -1):
        for b in range(15, -1, -1):
            rows.append((scalars_plain[limb] >> b) & 1)
    return torch.stack(rows).to(torch.bool)


def _msm_small(scalars_plain: torch.Tensor, points: PointBatch) -> PointBatch:
    """Σ s_i·P_i per lane by double-and-add, then a tree reduce over the
    last axis; scalars (16, *batch, N), points broadcast to that batch."""
    bshape = tuple(scalars_plain.shape[1:])
    lead = (N_LIMBS,) + (1,) * (len(bshape) - 1) + bshape[-1:]
    pts = PointBatch(*(c.reshape(lead).expand((N_LIMBS,) + bshape).contiguous()
                       for c in points))
    return _tree_reduce_last(
        padd_select_ladder(_bits_msb_first(scalars_plain), pts))


def _msm_pippenger(scalars_plain, points, c, group_log2=GROUP_LOG2,
                   lanes_log2=None, affine: bool = False):
    """(16, B, N) scalars -> batch (B,) via the bucket pipeline; `affine`
    takes the batched-affine bucket scan."""
    lanes_log2 = _lanes_log2(lanes_log2, affine)
    _, B, n = scalars_plain.shape
    n_windows = -(-SCALAR_BITS // c)
    digits, signs = signed_digits(scalars_plain, c)  # (W, B, N)
    digits_flat = digits.transpose(0, 1).reshape(B * n_windows, n)
    signs_flat = signs.transpose(0, 1).reshape(B * n_windows, n)
    buckets = _bucket_sums_all(digits_flat, signs_flat, points, c,
                               group_log2, lanes_log2, affine)
    wsums = _weighted_bucket_reduce_signed(buckets, c)  # batch (B·W,)
    per_col = PointBatch(*(
        coord.reshape(N_LIMBS, B, n_windows).transpose(1, 2) for coord in wsums
    ))  # batch (W, B)
    return _combine_windows(per_col, c)


def check_affine_precondition(points: PointBatch) -> None:
    """Raise ValueError unless every lane's z is 0 (the identity) or the
    Montgomery one: the Pippenger path lifts each point as (x, y, 1) via
    the mixed add, so a projective input would give a wrong sum without an
    error.  One compare and reduce over the z limbs, and a device sync."""
    z = points.z
    one = FQ.ones(z.shape[1:], z.device)
    if not bool(((z == 0).all(0) | (z == one).all(0)).all()):
        raise ValueError(
            "msm: points must be affine-or-identity (z per lane 0 or "
            "Montgomery one); normalize with to_affine_host/from_affine_host"
        )


def msm(scalars_plain: torch.Tensor, points: PointBatch,
        window_bits: int | None = None, group_log2: int = GROUP_LOG2,
        lanes_log2: int | None = None, check_affine: bool = False,
        affine: bool = False) -> PointBatch:
    """Σ s_i·P_i for (16, N) plain-form scalars; returns batch ().

    Points must be affine-or-identity (z per lane 0 or Montgomery one):
    the Pippenger path (N > 2^15) lifts them as (x, y, 1).  With
    `check_affine` that is checked first, on either path
    (`check_affine_precondition`).  `affine` takes the batched-affine
    bucket scan on the Pippenger path (`lanes_log2` then defaults to 17,
    else 15).
    """
    if check_affine:
        check_affine_precondition(points)
    n = scalars_plain.shape[-1]
    if n <= SMALL_MSM_LANES:
        return _msm_small(scalars_plain, points)
    c = window_bits or choose_window_bits(n)
    out = _msm_pippenger(scalars_plain[:, None], points, c, group_log2,
                         lanes_log2, affine)
    return PointBatch(*(coord[:, 0] for coord in out))


def msm_many(scalars_plain: torch.Tensor, points: PointBatch,
             window_bits: int | None = None, group_log2: int = GROUP_LOG2,
             lanes_log2: int | None = None, check_affine: bool = False,
             affine: bool = False) -> PointBatch:
    """MSM of B scalar vectors (16, B, N) against one point set; returns
    batch (B,).  Points must be affine-or-identity, as for `msm`, and
    `check_affine` checks it; `affine` as for `msm`."""
    if check_affine:
        check_affine_precondition(points)
    _, B, n = scalars_plain.shape
    if B * n <= SMALL_MSM_LANES:
        return _msm_small(scalars_plain, points)
    c = window_bits or choose_window_bits(n)
    return _msm_pippenger(scalars_plain, points, c, group_log2, lanes_log2,
                          affine)
