"""Mesh context: opt-in sharded execution for the whole prover.

Port of `tinyram_tpu/shard/context.py`.  `create_proof(..., mesh=mesh)`
runs the single-source prover under this context, and the prover consults
it at its device phases:

  * domain transforms route to the all-to-all four-step NTT (shard/ntt.py)
    on this rank's block (poly/domain.py): the whole-column transforms
    gather the output, the row-block ones (`coeff_to_extended_rows`) keep
    it as this rank's block;
  * commit and IPA MSMs route to point-sharded partials (shard/msm.py;
    ipa/ipa.py `_msm_dispatch`);
  * the quotient phase (plonk/prover.py `quotient_coeff`) runs on this
    rank's row blocks, rotations by halo exchange (shard/rows.py).

Every rank runs the same prover on the same replicated inputs; the other
elementwise phases run on whole columns on every rank.
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
