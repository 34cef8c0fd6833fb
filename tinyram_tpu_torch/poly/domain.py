"""Evaluation domains for the PLONKish prover.

Port of `tinyram_tpu/poly/domain.py`, with its mesh branch: under a mesh
context (`shard/context.py`) a transform whose four-step split the mesh
divides runs as the all-to-all sharded NTT on this rank's block of its
input, and the output is gathered, so the prover sees whole columns (the
row-sharded quotient phase, which would keep them sharded, is not ported
yet).  With its `domain_cache`: one `Domain` per (field, k, extended k,
device), so keygen, the key loader and the verifier share one domain and
its cached tables.

A `Domain` owns the size-n subgroup H (circuit rows) and the extended coset
g·H_ext used for quotient evaluation.  The coset generator is the field's
multiplicative generator, which lies in no 2-power subgroup, so Z_H never
vanishes on the coset.  Tensors are made on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.field import FP, FQ, Field
from ..field.params import N_LIMBS
from ..utils.algorithms import ntt_method
from ..utils.device import CUDA, resolve
from .ntt import _mont_table, coeff_scale, ntt, omega_for, powers


class Domain:
    def __init__(self, field: Field, k: int, extended_k: int, device=CUDA):
        assert extended_k >= k
        self.field = field
        self.device = resolve(device)
        self.k = k
        self.n = 1 << k
        self.extended_k = extended_k
        self.n_ext = 1 << extended_k
        p = field.modulus
        self.omega = omega_for(field, k)
        self.omega_inv = pow(self.omega, p - 2, p)
        self.omega_ext = omega_for(field, extended_k)
        self.g_coset = field.params.generator
        self.g_coset_inv = pow(self.g_coset, p - 2, p)
        self._l0_ext = None
        self._x_ext = None
        self._lsum_ext: dict = {}

    # ------------------------------------------------------------ transforms

    def _ntt(self, a: torch.Tensor, inverse: bool) -> torch.Tensor:
        """Single-device NTT by the algorithm of the active context
        (`utils/algorithms.py`), or, under a mesh context whose size
        divides the four-step split, the all-to-all sharded NTT of this
        rank's block, gathered."""
        from ..shard.context import current_mesh

        mesh = current_mesh()
        if mesh is not None:
            from ..shard.ntt import _split_rc, ntt_sharded

            n = a.shape[-1]
            D = mesh.size
            R, C = _split_rc(n.bit_length() - 1)
            if self.field.params.name == "Fp" and R % D == 0 and C % D == 0:
                out = ntt_sharded(mesh, mesh.block(a), inverse, self.field)
                return mesh.all_gather(out, -1)
        return ntt(self.field, a, inverse=inverse, method=ntt_method())

    def lagrange_to_coeff(self, a: torch.Tensor) -> torch.Tensor:
        """Evaluations on H (natural ω^i order) -> coefficients."""
        return self._ntt(a, True)

    def coeff_to_lagrange(self, a: torch.Tensor) -> torch.Tensor:
        return self._ntt(a, False)

    def coeff_to_extended(self, a: torch.Tensor) -> torch.Tensor:
        """Coefficients (len n or less) -> evaluations on the coset g·H_ext."""
        pad = self.n_ext - a.shape[-1]
        if pad:
            a = torch.cat(
                [a, self.field.zeros(a.shape[1:-1] + (pad,), a.device)], dim=-1
            )
        a = coeff_scale(self.field, a, self.g_coset)
        return self._ntt(a, False)

    def extended_to_coeff(self, a: torch.Tensor) -> torch.Tensor:
        """Evaluations on g·H_ext -> coefficients (length n_ext)."""
        a = self._ntt(a, True)
        return coeff_scale(self.field, a, self.g_coset_inv)

    # ---------------------------------------------------------- vanishing poly

    def divide_by_vanishing(self, evals_ext: torch.Tensor) -> torch.Tensor:
        """Divide coset-extended evaluations by Z_H(X) = X^n - 1.

        Z_H(g·ω_ext^i) = g^n·ω_ext^{n·i} - 1 cycles with period n_ext/n, so
        only that many inverses are needed (computed host-side).
        """
        p = self.field.modulus
        period = self.n_ext // self.n
        gn = pow(self.g_coset, self.n, p)
        wn = pow(self.omega_ext, self.n, p)  # order `period`
        vals = []
        cur = gn
        for _ in range(period):
            vals.append(pow(cur - 1, p - 2, p))
            cur = (cur * wn) % p
        tbl = torch.as_tensor(_mont_table(self.field, vals),
                              device=evals_ext.device)  # (16, period)
        full = tbl.repeat(1, self.n_ext // period)
        shape = (N_LIMBS,) + (1,) * (evals_ext.dim() - 2) + (self.n_ext,)
        return self.field.mul(evals_ext, full.reshape(shape))

    # ---------------------------------------------------------- host helpers

    def omega_powers(self) -> np.ndarray:
        """Host table of [1, ω, …, ω^{n-1}] (Montgomery)."""
        return powers(self.field, self.omega, self.n)

    def _coset_points(self) -> list[int]:
        """[g·ω_ext^i for i < n_ext] (host ints)."""
        p = self.field.modulus
        xs = [self.g_coset] * self.n_ext
        for i in range(1, self.n_ext):
            xs[i] = xs[i - 1] * self.omega_ext % p
        return xs

    def l0_evals_ext(self) -> np.ndarray:
        """Coset-extended evaluations of the first Lagrange basis poly l_0.

        l_0(X) = (X^n - 1) / (n (X - 1)).  Cached.  X^n cycles with period
        n_ext / n on the coset, and the n_ext denominators take one batch
        inversion (three products each and one modpow), not a modpow each:
        2^19 of them at config 3's size.
        """
        if self._l0_ext is None:
            p = self.field.modulus
            xs = self._coset_points()
            period = self.n_ext // self.n
            nums = [(pow(x, self.n, p) - 1) % p for x in xs[:period]]
            invs = _batch_inverse([self.n * (x - 1) % p for x in xs], p)
            vals = [nums[i % period] * inv % p for i, inv in enumerate(invs)]
            self._l0_ext = _mont_table(self.field, vals)
        return self._l0_ext

    def x_evals_ext(self) -> np.ndarray:
        """Evaluations of the identity polynomial X on the extended coset."""
        if self._x_ext is None:
            self._x_ext = _mont_table(self.field, self._coset_points())
        return self._x_ext

    def lagrange_sum_ext(self, rows: tuple) -> torch.Tensor:
        """Coset-extended evaluations of Σ_{i∈rows} l_i(X), cached.

        Used for the ZK usable-rows machinery: l_last (= l_u) and the
        blinding-row selector Σ_{i≥u} l_i in the lookup/permutation rules.
        """
        key = tuple(rows)
        if key not in self._lsum_ext:
            ind = np.zeros(self.n, dtype=np.int64)
            ind[list(key)] = 1
            lag = torch.as_tensor(
                _mont_table(self.field, ind.tolist()), device=self.device
            )
            self._lsum_ext[key] = self.coeff_to_extended(
                self.lagrange_to_coeff(lag)
            )
        return self._lsum_ext[key]

    def lagrange_evals_host(self, x: int, indices) -> list[int]:
        """l_i(x) for a host point x (verifier side), exact Python ints."""
        p = self.field.modulus
        zx = (pow(x, self.n, p) - 1) % p
        out = []
        n_inv = pow(self.n, p - 2, p)
        for i in indices:
            wi = pow(self.omega, i, p)
            den = (x - wi) % p
            li = zx * wi % p * n_inv % p * pow(den, p - 2, p) % p
            out.append(li)
        return out


def _batch_inverse(vals: list[int], p: int) -> list[int]:
    """[v^-1 mod p for v in vals] (all nonzero) by Montgomery's trick."""
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % p
    inv = pow(prefix[-1], p - 2, p)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv % p
        inv = inv * vals[i] % p
    return out


_DOMAINS: dict = {}


def domain_cache(field_name: str, k: int, extended_k: int,
                 device=CUDA) -> Domain:
    """The one `Domain` of `field_name` ("Fp" or "Fq") at (k, extended_k)
    on `device`, built on first use."""
    dev = resolve(device)
    key = (field_name, k, extended_k, str(dev))
    if key not in _DOMAINS:
        _DOMAINS[key] = Domain(FP if field_name == "Fp" else FQ, k, extended_k,
                               dev)
    return _DOMAINS[key]
