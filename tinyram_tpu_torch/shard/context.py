"""Mesh context: opt-in sharded execution for the whole prover.

Port of `tinyram_tpu/shard/context.py`.  `create_proof(..., mesh=mesh)`
runs the single-source prover under this context, and the prover consults
it at its device phases:

  * domain transforms route to the all-to-all four-step NTT (shard/ntt.py)
    on this rank's block, and the output is gathered (poly/domain.py);
  * commit and IPA MSMs route to point-sharded partials (shard/msm.py;
    ipa/ipa.py `_msm_dispatch`).

Every rank runs the same prover on the same replicated inputs; the
elementwise phases run on whole columns on every rank (the row-sharded
quotient phase, on `shard/rows.py`, is not ported yet).
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
