"""Row-sharded evaluation: rotations across rank boundaries.

The JAX package row-shards the elementwise phases under GSPMD, which
inserts a collective-permute for every `jnp.roll` (Rotation::next) whose
rows cross a device boundary.  Here each rank holds a block of rows, and
`rolled` builds its block of a rolled column, or of a (16, B, m) stack of
columns, with a halo exchange: the rows past the block come from the
neighbouring rank (`Mesh.permute`).  The prover's quotient phase rolls
its extended column blocks this way (`plonk/prover.py` `_Roll`, shifts of
rotation × n_ext/n rows).  `gate_eval_sharded` is the dry run's
row-sharded gate, x·(next(x) + x) (`__graft_entry__.py:128-140`).
"""

from __future__ import annotations

import torch

from ..field.field import FP
from .mesh import Mesh


def rolled(mesh: Mesh, x: torch.Tensor, shift: int) -> torch.Tensor:
    """This rank's block of `roll(X, -shift)` along the last (row) axis,
    where X is the whole column and `x` this rank's block of it (the last
    rank's next rows are rank 0's first, as roll wraps).  |shift| is at
    most the block's length (raises otherwise); leading axes are kept."""
    m = x.shape[-1]
    if not -m <= shift <= m:
        raise ValueError(f"rotation {shift} past a block of {m} rows")
    if shift == 0:
        return x
    D, r = mesh.size, mesh.rank
    if shift > 0:  # the next rank's first rows follow this block
        halo = mesh.permute(x[..., :shift], (r - 1) % D, (r + 1) % D)
        return torch.cat([x[..., shift:], halo], dim=-1)
    halo = mesh.permute(x[..., shift:], (r + 1) % D, (r - 1) % D)
    return torch.cat([halo, x[..., :shift]], dim=-1)


def gate_eval(x: torch.Tensor) -> torch.Tensor:
    """x·(next(x) + x) on a whole column (16, ..., n)."""
    return FP.mul(x, FP.add(torch.roll(x, -1, dims=-1), x))


def gate_eval_sharded(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of `gate_eval` of the whole column, from this
    rank's block `x`."""
    return FP.mul(x, FP.add(rolled(mesh, x, 1), x))
