"""Keygen: fixed-column and permutation-sigma commitments (vk/pk).

Port of `tinyram_tpu/plonk/keygen.py`.  The permutation argument follows
vanilla PLONK: cells are labelled δ^j·ω^i (column j, row i), copy
constraints merge label cycles, and σ_j polynomials encode the resulting
permutation.  δ = g^{2^s} (g the field generator, s the 2-adicity) so the
m column cosets δ^j·H are pairwise disjoint.  The key lives on the SRS's
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..curve.host import AffinePoint
from ..field.field import FP
from ..ipa import SRS
from ..ipa.ipa import commit_many
from ..poly.domain import Domain, domain_cache
from ..poly.ntt import _mont_table, omega_for
from .circuit import Assignment, Column, ConstraintSystem

P = FP.modulus


def delta() -> int:
    par = FP.params
    return pow(par.generator, 1 << par.two_adicity, P)


@dataclass
class VerifyingKey:
    cs: ConstraintSystem
    k: int
    extended_k: int
    fixed_commitments: list[AffinePoint]
    sigma_commitments: list[AffinePoint]
    perm_columns: list[Column]

    def absorb_into(self, t) -> None:
        for c in self.fixed_commitments:
            t.common_point(c)
        for c in self.sigma_commitments:
            t.common_point(c)


@dataclass
class ProvingKey:
    vk: VerifyingKey
    domain: Domain
    fixed_lag: list[torch.Tensor]
    fixed_coeff: list[torch.Tensor]
    sigma_lag: list[torch.Tensor]
    sigma_coeff: list[torch.Tensor]


def build_permutation_sigmas(
    cs: ConstraintSystem, n: int
) -> tuple[list[Column], list[np.ndarray]]:
    """Cycle-merge copy constraints into σ_j value tables (host ints)."""
    cols = cs.permutation_columns()
    col_pos = {c: j for j, c in enumerate(cols)}
    # mapping[(j, i)] = (j', i'): start as identity, merge cycles by swapping
    mapping = {}
    for j in range(len(cols)):
        for i in range(n):
            mapping[(j, i)] = (j, i)
    for (a, ar), (b, br) in cs.copies:
        ja, jb = col_pos[a], col_pos[b]
        mapping[(ja, ar)], mapping[(jb, br)] = (
            mapping[(jb, br)],
            mapping[(ja, ar)],
        )
    d = delta()
    # σ_j(ω^i) = δ^{j'}·ω^{i'} where mapping[(j,i)] = (j', i')
    omega = omega_for(FP, n.bit_length() - 1)
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % P
    delta_pows = [pow(d, j, P) for j in range(len(cols))]
    sigmas = []
    for j in range(len(cols)):
        vals = np.empty(n, dtype=object)
        for i in range(n):
            jp, ip = mapping[(j, i)]
            vals[i] = delta_pows[jp] * omega_pows[ip] % P
        sigmas.append(vals)
    return cols, sigmas


def keygen(
    srs: SRS, cs: ConstraintSystem, fixed_assignment: Assignment
) -> ProvingKey:
    """Build pk/vk.  ``fixed_assignment`` must have all fixed columns set."""
    k = srs.k
    n = 1 << k
    dev = srs.device
    assert fixed_assignment.n == n
    extended_k = k + cs.extension_factor_log2()
    domain = domain_cache("Fp", k, extended_k, dev)

    fixed_lag = []
    for i in range(cs.num_fixed):
        v = fixed_assignment.fixed[i]
        fixed_lag.append(v.to(dev) if v is not None else FP.zeros((n,), dev))
    perm_cols, sigma_tables = build_permutation_sigmas(cs, n)
    sigma_lag = [
        torch.as_tensor(_mont_table(FP, [int(v) for v in tbl]), device=dev)
        for tbl in sigma_tables
    ]
    all_lag = torch.stack(fixed_lag + sigma_lag, dim=1)
    all_coeff = domain.lagrange_to_coeff(all_lag)
    all_comms = commit_many(
        srs, [all_coeff[:, i] for i in range(all_coeff.shape[1])]
    )
    nf = len(fixed_lag)
    vk = VerifyingKey(
        cs=cs,
        k=k,
        extended_k=extended_k,
        fixed_commitments=all_comms[:nf],
        sigma_commitments=all_comms[nf:],
        perm_columns=perm_cols,
    )
    return ProvingKey(
        vk=vk,
        domain=domain,
        fixed_lag=fixed_lag,
        fixed_coeff=[all_coeff[:, i] for i in range(nf)],
        sigma_lag=sigma_lag,
        sigma_coeff=[all_coeff[:, nf + j] for j in range(len(sigma_lag))],
    )
