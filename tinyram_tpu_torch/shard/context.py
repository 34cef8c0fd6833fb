"""Mesh context: opt-in sharded execution for the whole prover.

Port of `tinyram_tpu/shard/context.py`.  `create_proof(..., mesh=mesh)`
runs the single-source prover under this context, and the prover consults
it at its device phases:

  * domain transforms route to the all-to-all four-step NTT (shard/ntt.py)
    on this rank's block (poly/domain.py): the whole-column transforms
    gather the output (the Lagrange side), the row-block ones (`*_rows`)
    keep it as this rank's block;
  * commit and IPA MSMs route to point-sharded partials (shard/msm.py;
    ipa/ipa.py `_msm_dispatch`), the commits from the rank's row blocks;
  * every coefficient column of the prover (plonk/prover.py) is this
    rank's row block, the quotient phase runs on its row blocks of the
    extended columns (rotations by halo exchange, shard/rows.py), and an
    evaluation sums the blocks' partials over the ranks (poly/ntt.py
    `eval_poly_rows`).

Every rank runs the same prover on the same replicated inputs; the
Lagrange columns and the host-side work stay whole on every rank.
"""

from __future__ import annotations

import contextlib

from .mesh import Mesh

_ACTIVE: list[Mesh] = []


def current_mesh() -> Mesh | None:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def mesh_context(mesh: Mesh | None):
    if mesh is None:
        yield
        return
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()
