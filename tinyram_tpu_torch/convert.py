"""Carry the JAX package's state over to the port, as numpy arrays.

Limb arrays keep the reference layout: `(16, ...)` 16-bit limbs in
Montgomery form (the reference's uint32 or any integer dtype), which
become the port's int32 tensors.  Points are affine `(x, y)` ints or None,
or `(N, 2, 32)` little-endian bytes with an identity mask.
"""

from __future__ import annotations

import numpy as np
import torch

from .curve import vesta
from .ipa.srs import SRS
from .plonk.circuit import ConstraintSystem
from .plonk.keygen import ProvingKey, VerifyingKey
from .poly.domain import domain_cache
from .utils.device import CUDA


def limbs(arr, device=CUDA) -> torch.Tensor:
    """(16, ...) reference limbs -> int32 tensor on `device`."""
    return torch.as_tensor(np.asarray(arr).astype(np.int32), device=device)


def points_from_bytes(raw: np.ndarray, is_none: np.ndarray) -> list:
    """(N, 2, 32) uint8 little-endian x, y + (N,) identity mask -> points."""
    out = []
    for xy, none in zip(raw, is_none):
        out.append(None if none else tuple(
            int.from_bytes(bytes(c), "little") for c in xy
        ))
    return out


def srs_from_numpy(g_x, g_y, g_z, u, w, device=CUDA) -> SRS:
    """The reference SRS: g as (16, n) Montgomery limbs (x, y, z), u and w
    as affine host points."""
    g = vesta.PointBatch(limbs(g_x, device), limbs(g_y, device),
                         limbs(g_z, device))
    n = g.x.shape[1]
    k = n.bit_length() - 1
    assert 1 << k == n
    return SRS(k=k, g_host=vesta.to_affine_host(g), u_host=tuple(u),
               w_host=tuple(w), g=g)


def pk_from_numpy(arrays: dict, cs: ConstraintSystem, device=CUDA) -> ProvingKey:
    """The reference ProvingKey from its arrays.

    ``arrays``: "k"; "fixed_lag", "fixed_coeff" (num_fixed, 16, n);
    optional "sigma_lag", "sigma_coeff" (num_sigma, 16, n); the
    commitments as "fixed_commitments"/"sigma_commitments" point lists.
    """
    k = int(arrays["k"])
    extended_k = k + cs.extension_factor_log2()

    def cols(name):
        if name not in arrays:
            return []
        return [limbs(c, device) for c in np.asarray(arrays[name])]

    vk = VerifyingKey(
        cs=cs, k=k, extended_k=extended_k,
        fixed_commitments=list(arrays["fixed_commitments"]),
        sigma_commitments=list(arrays.get("sigma_commitments", [])),
        perm_columns=cs.permutation_columns(),
    )
    return ProvingKey(
        vk=vk,
        domain=domain_cache("Fp", k, extended_k, device),
        fixed_lag=cols("fixed_lag"),
        fixed_coeff=cols("fixed_coeff"),
        sigma_lag=cols("sigma_lag"),
        sigma_coeff=cols("sigma_coeff"),
    )

