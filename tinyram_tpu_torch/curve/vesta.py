"""Batched Vesta point arithmetic (homogeneous projective, complete).

Port of `tinyram_tpu/curve/vesta.py`: the Renes-Costello-Batina 2016
complete formulas for a = 0, b = 5 (3b = 15) over Fq.  A point batch is a
NamedTuple of three `(16, *batch)` int32 limb tensors, identity = (0 : 1 : 0).

Each formula takes the field to compute in (`FQ`, whose multiplies run
kernel B1 on the card, or `FQ_PLAIN`) and is evaluated level by level:
the field multiplies (and adds) that do not depend on each other are
stacked and issued as one call, so a complete add is two multiply calls
of six products each.  Every field
operation returns canonical limbs, so the result is limb-for-limb the
reference's, whatever the grouping.  These functions are the plain
versions behind kernels B3-B6 (`cuda_point.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..field.field import FQ, Field


class PointBatch(NamedTuple):
    """Homogeneous projective Vesta points, coordinates in Montgomery form."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[1:])


def identity(batch_shape=(), device="cpu") -> PointBatch:
    return PointBatch(
        FQ.zeros(batch_shape, device), FQ.ones(batch_shape, device),
        FQ.zeros(batch_shape, device),
    )


def from_affine_host(points, device="cpu") -> PointBatch:
    """List of host affine points ((x, y) or None) -> PointBatch."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0]), ys.append(pt[1]), zs.append(1)
    return PointBatch(
        FQ.encode(xs, device=device), FQ.encode(ys, device=device),
        FQ.encode(zs, device=device),
    )


def to_affine_host(p: PointBatch):
    """PointBatch -> list of host affine points (or None)."""
    xs = FQ.decode(p.x)
    ys = FQ.decode(p.y)
    zs = FQ.decode(p.z)
    out = []
    q = FQ.modulus
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, q - 2, q)
            out.append((x * zi % q, y * zi % q))
    return out


def _many(op, pairs):
    """Apply a binary field op to several same-shape pairs in one call."""
    if len(pairs) == 1:
        return (op(*pairs[0]),)
    a = torch.stack([x for x, _ in pairs], dim=1)
    b = torch.stack([y for _, y in pairs], dim=1)
    return op(a, b).unbind(1)


class _Batched:
    """A field's add/sub/mul, each applied to several pairs in one call."""

    def __init__(self, F: Field):
        self.F = F

    def mul(self, *pairs):
        return _many(self.F.mul, pairs)

    def add(self, *pairs):
        return _many(self.F.add, pairs)

    def sub(self, *pairs):
        return _many(self.F.sub, pairs)

    def times_15_16(self, ts, extra):
        """[15·t for t in ts] (16t - t, the reference's 3b add chain) and
        [2^j·e for (e, j) in extra], sharing the doubling levels."""
        vals = list(ts) + [e for e, _ in extra]
        want = [4] * len(ts) + [j for _, j in extra]
        out = list(vals)
        for level in range(max(want)):
            idx = [i for i, w in enumerate(want) if w > level]
            res = self.add(*[(out[i], out[i]) for i in idx])
            for i, r in zip(idx, res):
                out[i] = r
        fifteen = self.sub(*[(out[i], vals[i]) for i in range(len(ts))])
        return list(fifteen), out[len(ts):]


def add(p: PointBatch, q: PointBatch, F: Field = FQ) -> PointBatch:
    """Complete addition, RCB16 Algorithm 7 specialized to a = 0, b3 = 15."""
    o = _Batched(F)
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    xy1, xy2, yz1, yz2, xz1, xz2 = o.add(
        (X1, Y1), (X2, Y2), (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2)
    )
    t0, t1, t2, m3, m4, m5 = o.mul(
        (X1, X2), (Y1, Y2), (Z1, Z2), (xy1, xy2), (yz1, yz2), (xz1, xz2)
    )
    u3, u4, u5 = o.add((t0, t1), (t1, t2), (t0, t2))
    t3, t4, y3 = o.sub((m3, u3), (m4, u4), (m5, u5))  # X1Y2+X2Y1, ...
    t0x2, = o.add((t0, t0))
    t0x3, = o.add((t0x2, t0))  # 3·X1X2
    (t2b, y3b), _ = o.times_15_16([t2, y3], [])  # 3b·Z1Z2, 3b·(X1Z2+X2Z1)
    z3, = o.add((t1, t2b))
    t1b, = o.sub((t1, t2b))
    x3a, t2c, y3c, t1c, t0c, z3c = o.mul(
        (t4, y3b), (t3, t1b), (y3b, t0x3), (t1b, z3), (t0x3, t3), (z3, t4)
    )
    X3, = o.sub((t2c, x3a))
    Y3, Z3 = o.add((t1c, y3c), (z3c, t0c))
    return PointBatch(X3, Y3, Z3)


def add_mixed(p: PointBatch, qx: torch.Tensor, qy: torch.Tensor,
              F: Field = FQ) -> PointBatch:
    """p + (qx, qy, 1), RCB16 Algorithm 8 (mixed, a = 0, b3 = 15).

    Complete in p (including identity); q must NOT be the identity — the
    MSM routes identity inputs to the spill bucket before using this.
    """
    o = _Batched(F)
    X1, Y1, Z1 = p
    X2, Y2 = qx, qy
    s2, s1 = o.add((X2, Y2), (X1, Y1))
    t0, t1, t3, t4, y3 = o.mul((X1, X2), (Y1, Y2), (s2, s1), (Y2, Z1), (X2, Z1))
    u, t4, y3 = o.add((t0, t1), (t4, Y1), (y3, X1))  # ., Y1+Y2Z1, X1+X2Z1
    t3, = o.sub((t3, u))  # X1Y2 + X2Y1
    t0x2, = o.add((t0, t0))
    t0x3, = o.add((t0x2, t0))
    (t2, y3b), _ = o.times_15_16([Z1, y3], [])  # 3b·Z1, 3b·(X1 + X2Z1)
    z3, = o.add((t1, t2))
    t1b, = o.sub((t1, t2))
    x3a, t2c, y3c, t1c, t0c, z3c = o.mul(
        (t4, y3b), (t3, t1b), (y3b, t0x3), (t1b, z3), (t0x3, t3), (z3, t4)
    )
    X3, = o.sub((t2c, x3a))
    Y3, Z3 = o.add((t1c, y3c), (z3c, t0c))
    return PointBatch(X3, Y3, Z3)


def double(p: PointBatch, F: Field = FQ) -> PointBatch:
    """Exception-free doubling, RCB16 Algorithm 9 (a = 0, b3 = 15)."""
    o = _Batched(F)
    X, Y, Z = p
    t0, t1, t2, xy = o.mul((Y, Y), (Y, Z), (Z, Z), (X, Y))
    (t2b,), (z3a,) = o.times_15_16([t2], [(t0, 3)])  # 3b·Z², 8Y²
    x3a, z3 = o.mul((t2b, z3a), (t1, z3a))
    y3a, t2x2 = o.add((t0, t2b), (t2b, t2b))
    t2x3, = o.add((t2x2, t2b))
    t0b, = o.sub((t0, t2x3))
    y3b, x3b = o.mul((t0b, y3a), (t0b, xy))
    Y3, X3 = o.add((x3a, y3b), (x3b, x3b))
    return PointBatch(X3, Y3, z3)


def scalar_mul(scalar_bits: torch.Tensor, p: PointBatch) -> PointBatch:
    """Double-and-add over a (255, *batch) bit tensor (msb first), as the
    reference's `scalar_mul`: from the identity, acc = 2·acc, then acc + p
    where the bit is set.  One launch of the ladder B5l on the card (its
    plain loop on the CPU); the complete add is symmetric in its operands,
    so B5l's p + 2·acc is the reference's 2·acc + p limb for limb."""
    from .cuda_point import padd_select_ladder  # cuda_point imports vesta

    return padd_select_ladder(scalar_bits.to(torch.bool), p)


def neg(p: PointBatch) -> PointBatch:
    return PointBatch(p.x, FQ.neg(p.y), p.z)


def select(mask: torch.Tensor, p: PointBatch, q: PointBatch) -> PointBatch:
    """where(mask, p, q) with mask shaped like the batch."""
    return PointBatch(
        FQ.select(mask, p.x, q.x),
        FQ.select(mask, p.y, q.y),
        FQ.select(mask, p.z, q.z),
    )


def is_identity(p: PointBatch) -> torch.Tensor:
    return FQ.is_zero(p.z)


def eq(p: PointBatch, q: PointBatch) -> torch.Tensor:
    """Group equality via cross-multiplication (handles identity)."""
    pz0, qz0 = FQ.is_zero(p.z), FQ.is_zero(q.z)
    both_inf = pz0 & qz0
    one_inf = pz0 ^ qz0
    x_cross = FQ.eq(FQ.mul(p.x, q.z), FQ.mul(q.x, p.z))
    y_cross = FQ.eq(FQ.mul(p.y, q.z), FQ.mul(q.y, p.z))
    finite_eq = x_cross & y_cross
    return torch.where(both_inf, True, torch.where(one_inf, False, finite_eq))
