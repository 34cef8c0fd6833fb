"""Proving/verifying key persistence.

Port of `tinyram_tpu/plonk/serialize.py`, in its `.npz` format: the same
keys, limbs stored as uint32 `(cols, 16, n)` arrays, commitments as
`(N, 2, 32)` little-endian bytes (zeros for the identity) and the
permutation columns as a `U16` `(m, 2)` array of (kind, index).  A file
saved by either package loads in the other.  The ConstraintSystem itself is
code: loading re-derives it from the circuit builder, and the file carries
only arrays and commitments.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curve.host import AffinePoint
from ..field.params import N_LIMBS
from ..poly.domain import domain_cache
from ..utils.device import CUDA
from .circuit import Column, ConstraintSystem
from .keygen import ProvingKey, VerifyingKey


def _points_to_arr(points: list[AffinePoint]) -> np.ndarray:
    out = np.zeros((len(points), 2, 32), dtype=np.uint8)
    for i, pt in enumerate(points):
        if pt is None:
            continue
        out[i, 0] = np.frombuffer(pt[0].to_bytes(32, "little"), np.uint8)
        out[i, 1] = np.frombuffer(pt[1].to_bytes(32, "little"), np.uint8)
    return out


def _arr_to_points(arr: np.ndarray) -> list[AffinePoint]:
    out = []
    for i in range(arr.shape[0]):
        x = int.from_bytes(arr[i, 0].tobytes(), "little")
        y = int.from_bytes(arr[i, 1].tobytes(), "little")
        out.append(None if x == 0 and y == 0 else (x, y))
    return out


def _stack(cols: list) -> np.ndarray:
    if not cols:
        return np.zeros((0, N_LIMBS, 1), np.uint32)
    return np.stack([c.cpu().numpy() for c in cols]).astype(np.uint32)


def _limbs(arr: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(arr.astype(np.int32), device=device)


def save_pk(path: str, pk: ProvingKey) -> None:
    np.savez_compressed(
        path,
        k=pk.vk.k,
        extended_k=pk.vk.extended_k,
        fixed_lag=_stack(pk.fixed_lag),
        fixed_coeff=_stack(pk.fixed_coeff),
        sigma_lag=_stack(pk.sigma_lag),
        sigma_coeff=_stack(pk.sigma_coeff),
        fixed_comms=_points_to_arr(pk.vk.fixed_commitments),
        sigma_comms=_points_to_arr(pk.vk.sigma_commitments),
        perm_cols=np.array(
            [(c.kind, str(c.index)) for c in pk.vk.perm_columns], dtype="U16"
        ).reshape(-1, 2),
    )


def load_pk(path: str, cs: ConstraintSystem, device=CUDA) -> ProvingKey:
    """The key saved at `path`, for the circuit `cs`, on `device`."""
    data = np.load(path)
    k = int(data["k"])
    ek = int(data["extended_k"])
    perm_cols = [
        Column(kind, int(idx)) for kind, idx in data["perm_cols"]
    ]
    vk = VerifyingKey(
        cs=cs,
        k=k,
        extended_k=ek,
        fixed_commitments=_arr_to_points(data["fixed_comms"]),
        sigma_commitments=_arr_to_points(data["sigma_comms"]),
        perm_columns=perm_cols,
    )
    domain = domain_cache("Fp", k, ek, device)
    return ProvingKey(
        vk=vk,
        domain=domain,
        fixed_lag=[_limbs(v, domain.device) for v in data["fixed_lag"]],
        fixed_coeff=[_limbs(v, domain.device) for v in data["fixed_coeff"]],
        sigma_lag=[_limbs(v, domain.device) for v in data["sigma_lag"]],
        sigma_coeff=[_limbs(v, domain.device) for v in data["sigma_coeff"]],
    )
