"""Algorithm context: which NTT and which MSM bucket scan a proof runs.

`create_proof(..., ntt_method=, msm_affine=)` runs the prover under this
context, and the prover consults it where the reference reads its
environment at trace time: `Domain._ntt` passes `ntt_method()` to
`poly.ntt.ntt` (the reference's `TINYRAM_NTT=mxu`), and the IPA's
`_msm_dispatch` (commitments and opening rounds) passes `msm_affine()` to
`msm_many` (the reference's `TINYRAM_MSM_AFFINE=1`).  Both give the same
proof bytes as the defaults.  Under a mesh context the sharded paths keep
their algorithms (the reference's `shard/` reads neither switch).
"""

from __future__ import annotations

import contextlib

NTT_METHODS = ("b2", "mxu")
DEFAULT = ("b2", False)

_ACTIVE: list[tuple[str, bool]] = []


def ntt_method() -> str:
    return (_ACTIVE[-1] if _ACTIVE else DEFAULT)[0]


def msm_affine() -> bool:
    return (_ACTIVE[-1] if _ACTIVE else DEFAULT)[1]


@contextlib.contextmanager
def algorithms(ntt_method: str = "b2", msm_affine: bool = False):
    if ntt_method not in NTT_METHODS:
        raise ValueError(f"ntt_method {ntt_method!r} not in {NTT_METHODS}")
    _ACTIVE.append((ntt_method, bool(msm_affine)))
    try:
        yield
    finally:
        _ACTIVE.pop()
