"""Evaluation domains for the PLONKish prover.

Port of `tinyram_tpu/poly/domain.py`, with its mesh branch.  The
whole-column transforms (`lagrange_to_coeff`, `coeff_to_extended`, ...)
run on one device, mesh or not.  The row-block ones, which the prover
runs for every coefficient column under a mesh context
(`shard/context.py`), run as the all-to-all sharded NTT when the mesh
divides the transform's four-step split: `lagrange_to_coeff_rows`,
`coeff_to_lagrange_rows` and `coeff_to_extended_rows` take this rank's
row block and return this rank's row block (n/D or n_ext/D rows), and
`extended_rows_to_coeff` gathers only the coefficients it returns.  So a
rank holds its block of every coefficient and extended column, as the JAX
package's shard_map out_specs leave it under GSPMD (`tinyram_tpu/shard/
ntt.py:118-122`, `tinyram_tpu/plonk/prover.py:577-592`).  `block` and
`gather` move a column between the two forms.  The extended tables have
block forms (`ext_table_rows`) cut from the cached whole tables.  One coset
g·ω_ext^j·H of the extended domain, the whole's rows t ≡ j (mod n_ext/n),
has its lift (`coeff_to_coset_rows`, a size-n transform) and its tables'
rows (`coset_rows`), row blocks under a mesh as well.  With its
`domain_cache`: one `Domain` per (field, k, extended k, device), so
keygen, the key loader and the verifier share one domain and its cached
tables.

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

    def _ntt_local(self, a: torch.Tensor, inverse: bool) -> torch.Tensor:
        """Single-device NTT by the algorithm of the active context
        (`utils/algorithms.py`)."""
        return ntt(self.field, a, inverse=inverse, method=ntt_method())

    def _splits(self, mesh, n: int) -> bool:
        """Whether `mesh` splits a transform of n points (`ntt_sharded`
        needs Fp and R % D == C % D == 0)."""
        from ..shard.ntt import _split_rc

        R, C = _split_rc(n.bit_length() - 1)
        D = mesh.size
        return self.field.params.name == "Fp" and R % D == 0 and C % D == 0

    def lagrange_to_coeff(self, a: torch.Tensor) -> torch.Tensor:
        """Evaluations on H (natural ω^i order) -> coefficients."""
        return self._ntt_local(a, True)

    def coeff_to_lagrange(self, a: torch.Tensor) -> torch.Tensor:
        return self._ntt_local(a, False)

    def _pad_ext(self, a: torch.Tensor) -> torch.Tensor:
        pad = self.n_ext - a.shape[-1]
        if pad:
            a = torch.cat(
                [a, self.field.zeros(a.shape[1:-1] + (pad,), a.device)], dim=-1
            )
        return a

    def coeff_to_extended(self, a: torch.Tensor) -> torch.Tensor:
        """Coefficients (len n or less) -> evaluations on the coset g·H_ext."""
        a = coeff_scale(self.field, self._pad_ext(a), self.g_coset)
        return self._ntt_local(a, False)

    def extended_to_coeff(self, a: torch.Tensor) -> torch.Tensor:
        """Evaluations on g·H_ext -> coefficients (length n_ext)."""
        a = self._ntt_local(a, True)
        return coeff_scale(self.field, a, self.g_coset_inv)

    def block(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's row block of a whole column (16, ..., n) along its
        last axis under a mesh context (a view, no collective); `a` itself
        with no mesh."""
        from ..shard.context import current_mesh

        mesh = current_mesh()
        return a if mesh is None else mesh.block(a)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole column from every rank's row block along the last axis
        (one `all_gather`) under a mesh context; `block` itself with no
        mesh."""
        from ..shard.context import current_mesh

        mesh = current_mesh()
        return block if mesh is None else mesh.all_gather(block, -1)

    def _ntt_rows(self, block: torch.Tensor, inverse: bool) -> torch.Tensor:
        """This rank's row block of the size-n transform from its row block
        of the input, no gather.  A mesh that does not split the transform
        gathers the input, transforms it whole and takes the block (counted
        in "mesh.unsplit"); with no mesh, the whole transform."""
        from ..shard.context import current_mesh

        mesh = current_mesh()
        if mesh is None:
            return self._ntt_local(block, inverse)
        if not self._splits(mesh, block.shape[-1] * mesh.size):
            mesh.count_unsplit(block)
            whole = mesh.all_gather(block, -1)
            return mesh.block(self._ntt_local(whole, inverse)).contiguous()
        from ..shard.ntt import ntt_sharded

        return ntt_sharded(mesh, block, inverse, self.field)

    def lagrange_to_coeff_rows(self, block: torch.Tensor) -> torch.Tensor:
        """This rank's row block (16, ..., n/D) of evaluations on H ->
        this rank's row block of the coefficients (the whole of both with
        no mesh)."""
        return self._ntt_rows(block, True)

    def coeff_to_lagrange_rows(self, block: torch.Tensor) -> torch.Tensor:
        """This rank's row block (16, ..., n/D) of coefficients -> this
        rank's row block of the evaluations on H."""
        return self._ntt_rows(block, False)

    def coeff_to_extended_rows(self, block: torch.Tensor) -> torch.Tensor:
        """This rank's row block (16, ..., n/D) of coefficients -> this
        rank's row block (16, ..., n_ext/D) of their evaluations on g·H_ext:
        the sharded NTT's output as it is, no gather.  The zero pad to
        n_ext is folded into the transform's first all-to-all
        (`ntt_sharded(n=n_ext)`): each rank scales its block by g^i from
        its first row, and the blocks are exchanged as they are, so a lift
        sends (D−1)/D of n/D elements a column there instead of (D−1)/D of
        n_ext/D.  A mesh that does not split the transform, or whose
        blocks are not whole rows of its (R, C) split, gathers the block
        and lifts the whole column (counted in "mesh.unsplit").  With no
        mesh, `coeff_to_extended` (the whole column)."""
        from ..shard.context import current_mesh
        from ..shard.ntt import _split_rc

        mesh = current_mesh()
        if mesh is None:
            return self.coeff_to_extended(block)
        if not self._splits(mesh, self.n_ext) \
                or block.shape[-1] % _split_rc(self.extended_k)[1]:
            mesh.count_unsplit(block)
            whole = mesh.all_gather(block, -1)
            return mesh.block(self.coeff_to_extended(whole)).contiguous()
        from ..shard.ntt import ntt_sharded

        body = coeff_scale(self.field, block, self.g_coset,
                           offset=mesh.rank * block.shape[-1])
        return ntt_sharded(mesh, body, False, self.field, n=self.n_ext)

    def coeff_to_coset_rows(self, block: torch.Tensor, j: int) -> torch.Tensor:
        """This rank's row block (16, ..., n/D) of coefficients -> this
        rank's row block (16, ..., n/D) of their evaluations on the coset
        g·ω_ext^j·H (j < n_ext/n): rows t = (n_ext/n)·i + j of the whole
        lift (`coeff_to_extended`), since g·ω_ext^t = (g·ω_ext^j)·ω^i.  A
        size-n transform (`lagrange_to_coeff_rows`' forward twin) of the
        coefficients scaled by (g·ω_ext^j)^i: a fraction n/n_ext of the
        whole lift's output, and no zero pad."""
        from ..shard.context import current_mesh

        p = self.field.modulus
        mesh = current_mesh()
        offset = 0 if mesh is None else mesh.rank * block.shape[-1]
        shift = self.g_coset * pow(self.omega_ext, j, p) % p
        return self._ntt_rows(coeff_scale(self.field, block, shift,
                                          offset=offset), False)

    def extended_rows_to_coeff(self, block: torch.Tensor) -> torch.Tensor:
        """This rank's row block of evaluations on g·H_ext -> the whole
        coefficients (16, ..., n_ext) on every rank: the sharded inverse
        NTT of the block, the coset scale of its rows, then one
        `all_gather`.  A mesh that does not split the transform gathers
        the evaluations instead (counted in "mesh.unsplit").  With no
        mesh, `extended_to_coeff`."""
        from ..shard.context import current_mesh

        mesh = current_mesh()
        if mesh is None:
            return self.extended_to_coeff(block)
        if not self._splits(mesh, self.n_ext):
            mesh.count_unsplit(block)
            whole = mesh.all_gather(block, -1)
            return coeff_scale(self.field, self._ntt_local(whole, True),
                               self.g_coset_inv)
        from ..shard.ntt import ntt_sharded

        out = ntt_sharded(mesh, block, True, self.field)
        out = coeff_scale(self.field, out, self.g_coset_inv,
                          offset=mesh.rank * block.shape[-1])
        return mesh.all_gather(out, -1)

    # ---------------------------------------------------------- vanishing poly

    def divide_by_vanishing(self, evals_ext: torch.Tensor) -> torch.Tensor:
        """Divide coset-extended evaluations by Z_H(X) = X^n - 1: the
        whole column, or a rank's row block of it (its length L divides
        n_ext; a block of D ≤ n ranks starts at a multiple of L).

        Z_H(g·ω_ext^i) = g^n·ω_ext^{n·i} - 1 cycles with period n_ext/n, so
        only that many inverses are needed (computed host-side); a block
        starts at a multiple of the period, so its table is the same.
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
        length = evals_ext.shape[-1]
        assert length % period == 0 and self.n_ext % length == 0, (
            f"{length} rows: not a block of a mesh of at most n = {self.n} "
            f"ranks over {self.n_ext}")
        full = tbl.repeat(1, length // period)
        shape = (N_LIMBS,) + (1,) * (evals_ext.dim() - 2) + (length,)
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
            # single-device transforms on every rank: a table of the
            # domain, the same whatever mesh is active (no collective)
            coeff = self._ntt_local(lag, True)
            self._lsum_ext[key] = self._ntt_local(coeff_scale(
                self.field, self._pad_ext(coeff), self.g_coset), False)
        return self._lsum_ext[key]

    # ------------------------------------------------- row blocks of tables

    def ext_table_rows(self, table) -> torch.Tensor:
        """This rank's row block of a whole extended table (host or device,
        `l0_evals_ext`, `x_evals_ext`, `lagrange_sum_ext`) on the domain's
        device; the whole table with no mesh."""
        from ..shard.context import current_mesh

        mesh = current_mesh()
        if mesh is not None:
            m = table.shape[-1] // mesh.size
            table = table[..., mesh.rank * m:(mesh.rank + 1) * m]
        if isinstance(table, np.ndarray):
            return torch.as_tensor(np.ascontiguousarray(table),
                                   device=self.device)
        return table.contiguous()

    def coset_rows(self, table, j: int) -> torch.Tensor:
        """This rank's row block of a whole extended table's rows
        t ≡ j (mod n_ext/n): the table on the coset g·ω_ext^j·H
        (`coeff_to_coset_rows`)."""
        return self.ext_table_rows(table[..., j :: self.n_ext // self.n])

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
