"""Inner-product-argument polynomial commitment: commit / open / verify.

Port of `tinyram_tpu/ipa/ipa.py` (same protocol, same transcript traffic):

  commit(f)      = MSM(coeffs(f), G) (+ blind·W for hiding)
  open at x:     k rounds; round j splits the vector lo ‖ hi, sends
                 L_j = ⟨a_lo, G_hi⟩ + ⟨a_lo, b_hi⟩·U + ξ_L·W and
                 R_j = ⟨a_hi, G_lo⟩ + ⟨a_hi, b_lo⟩·U + ξ_R·W, folds with
                 the challenge u_j; the final message is a₀ and the
                 collapsed blind ξ.
  verify:        s_t = Π_j (u_j or u_j⁻¹ by bit j of t); one size-n MSM.

The prover never folds G in the group: each round's two inner products
with the folded G are one batched MSM over the original G with
gathered, masked scalars.  Randomness comes from `rng.randbelow`.

The prover's MSMs (each round's pair and `commit_many`'s passes) go
through `_msm_dispatch`: under a mesh context, the point-sharded MSM of
`shard/msm.py` over this rank's block of scalars and generators.  The
scalars come in one of two forms, named by the caller and never guessed
from a shape: whole vectors, cut to the rank's block there (the opening
rounds), or `rows=True`, this rank's row block of each vector already
(`commit`/`commit_many`, whose entries under a mesh are the prover's
coefficient blocks), as the JAX `msm_many_sharded` takes the
block-sharded output of `ntt_sharded` (`tinyram_tpu/shard/msm.py:41-47`).
"""

from __future__ import annotations

import secrets
from functools import lru_cache

import numpy as np
import torch

from ..curve import PointBatch, host_jacobian, msm, msm_many, to_affine_host
from ..curve.host import AffinePoint
from ..field.field import FP
from ..poly.ntt import powers, tree_sum
from ..transcript.transcript import TranscriptReader, TranscriptWriter
from ..utils.algorithms import msm_affine
from .srs import SRS

P = FP.modulus
COMMIT_CHUNK = 64  # columns per batched MSM pass (reference default)


def _msm_dispatch(scalars_plain: torch.Tensor, points: PointBatch,
                  rows: bool = False) -> PointBatch:
    """`msm_many` of (16, B, N) scalars with the bucket scan of the active
    context (`utils/algorithms.py`), or, when a mesh context is active, the
    point-sharded `msm_many_sharded` of this rank's block: of the whole
    scalars when their N divides over the mesh, or, with `rows`, the
    scalars as given, which are this rank's block of N·D already."""
    from ..shard.context import current_mesh

    mesh = current_mesh()
    if mesh is not None and (rows or scalars_plain.shape[-1] % mesh.size == 0):
        from ..shard.msm import msm_many_sharded

        if not rows:
            scalars_plain = mesh.block(scalars_plain)
        return msm_many_sharded(mesh, scalars_plain,
                                PointBatch(*(mesh.block(c) for c in points)))
    return msm_many(scalars_plain, points, affine=msm_affine())


def commit(srs: SRS, coeffs: torch.Tensor, blind: int = 0,
           commit_chunk: int = COMMIT_CHUNK) -> AffinePoint:
    """Commit to a (16, m) Montgomery coefficient vector, m <= 2^k (this
    rank's row block under a mesh context, as in `commit_many`);
    ``blind`` adds blind·W (0 for public polynomials)."""
    return commit_many(srs, [coeffs], blinds=[blind],
                       commit_chunk=commit_chunk)[0]


@lru_cache(maxsize=None)
def _fold_maps(k: int):
    """Static gather/mask tables per round: after j folds the original
    index t sits at logical position t mod (n >> j)."""
    n = 1 << k
    t = np.arange(n)
    maps = []
    for j in range(k):
        m = n >> j  # current vector length
        pos = t % m
        in_hi = (pos >= m // 2).astype(np.int32)
        lo_index = np.where(pos >= m // 2, pos - m // 2, pos)
        maps.append((lo_index.astype(np.int64), in_hi))
    return maps


def open_poly(
    srs: SRS, tw: TranscriptWriter, coeffs: torch.Tensor, x: int,
    blind: int = 0, rng=secrets,
) -> None:
    """IPA opening proof for f(x); appends k (L, R) pairs, a₀ and the
    blinding sync scalar ξ to ``tw``.

    ``coeffs``: (16, m) Montgomery form; ``blind`` is the W-blind of the
    commitment being opened; ``rng.randbelow`` draws the round blinds (the
    `secrets` module by default).  The caller has absorbed the
    commitment, x and the claimed value beforehand.
    """
    k, n = srs.k, srs.n
    dev = coeffs.device
    m = coeffs.shape[-1]
    if m < n:
        coeffs = torch.cat([coeffs, FP.zeros((n - m,), dev)], dim=-1)
    a = coeffs
    b = torch.as_tensor(powers(FP, x % P, n), device=dev)
    gamma = FP.ones((n,), dev)
    maps = _fold_maps(k)
    u_base = srs.u_host

    for j in range(k):
        lo_index, in_hi = maps[j]
        lo_index = torch.as_tensor(lo_index, device=dev)
        hi_sel = torch.as_tensor(in_hi, device=dev)  # 1 where t folds into hi
        m_j = n >> j
        half = m_j // 2
        a_lo = a[:, :half]
        a_hi = a[:, half:m_j]
        b_lo = b[:, :half]
        b_hi = b[:, half:m_j]
        # L_j = <a_lo, G_hi> + <a_lo, b_hi> U: the scalar of original index
        # t is gamma_t * a_lo[lo_index[t]] where t lies in the hi half
        wL = FP.mul(gamma, a_lo[:, lo_index]) * hi_sel[None]
        wR = FP.mul(gamma, a_hi[:, lo_index]) * (1 - hi_sel)[None]
        sL = FP.decode(tree_sum(FP, FP.mul(a_lo, b_hi))[:, None])[0]
        sR = FP.decode(tree_sum(FP, FP.mul(a_hi, b_lo))[:, None])[0]
        lr = to_affine_host(
            _msm_dispatch(FP.from_mont(torch.stack([wL, wR], dim=1)), srs.g)
        )
        L_base, R_base = lr[0], lr[1]
        xi_l, xi_r = rng.randbelow(P), rng.randbelow(P)
        L = host_jacobian.lincomb([(sL, u_base), (xi_l, srs.w_host)], L_base)
        R = host_jacobian.lincomb([(sR, u_base), (xi_r, srs.w_host)], R_base)
        tw.write_point(L)
        tw.write_point(R)
        u = tw.challenge()
        u_inv = pow(u, P - 2, P)
        blind = (blind + u * u % P * xi_l + u_inv * u_inv % P * xi_r) % P
        ud = FP.const(u, 1, dev)
        uid = FP.const(u_inv, 1, dev)
        a = FP.add(FP.mul(ud, a_lo), FP.mul(uid, a_hi))
        b = FP.add(FP.mul(uid, b_lo), FP.mul(ud, b_hi))
        # gamma picks up u for hi-half indices, u_inv for lo-half ones
        gamma = FP.select(hi_sel.to(torch.bool), FP.mul(gamma, ud),
                          FP.mul(gamma, uid))

    a0 = FP.decode(a[:, :1])[0]
    tw.write_scalar(a0)
    tw.write_scalar(blind)  # ξ_final


def verify_open_deferred(
    srs: SRS,
    tr: TranscriptReader,
    commitment: AffinePoint,
    x: int,
    v: int,
):
    """Parse an IPA opening and return its check as a deferred linear
    relation (g_scalars, terms): valid iff
    ⟨g_scalars, G⟩ + Σ scalar·point over terms == identity."""
    k, n = srs.k, srs.n
    lrs = []
    us = []
    for _ in range(k):
        L = tr.read_point()
        R = tr.read_point()
        u = tr.challenge()
        lrs.append((L, R))
        us.append(u)
    a0 = tr.read_scalar()
    xi_final = tr.read_scalar()

    # s = kron([u_0^{-1}, u_0], [u_1^{-1}, u_1], ...) by doubling over
    # numpy object arrays; round j controls index bit (k-1-j)
    u_invs = [pow(u, P - 2, P) for u in us]
    s = np.array([1], dtype=object)
    for u, u_inv in zip(us, u_invs):
        s = np.concatenate([s * u_inv % P, s * u % P])
    t = np.arange(n, dtype=np.int64)
    rt = np.zeros(n, dtype=np.int64)
    for _ in range(k):
        rt = (rt << 1) | (t & 1)
        t >>= 1
    s_arr = s[rt]

    # b0 = Σ_t s_t x^t = Π_j (u_j^{-1} + u_j·x^{2^{k-1-j}})
    b0 = 1
    for j, (u, u_inv) in enumerate(zip(us, u_invs)):
        b0 = b0 * (u_inv + u * pow(x % P, 1 << (k - 1 - j), P)) % P

    #   a0·⟨s,G⟩ + (a0·b0 − v)·U + ξ·W − C − Σ u²·L − Σ u⁻²·R == 0
    g_scalars = s_arr * a0 % P
    terms = [
        ((a0 * b0 - v) % P, srs.u_host),
        (xi_final % P, srs.w_host),
        (P - 1, commitment),
    ]
    for (L, R), u in zip(lrs, us):
        u_inv = pow(u, P - 2, P)
        terms.append((P - u * u % P, L))
        terms.append((P - u_inv * u_inv % P, R))
    return g_scalars, terms


def check_deferred(srs: SRS, g_scalars, terms: list) -> bool:
    """Evaluate one deferred relation (device MSM for ⟨g_scalars, G⟩)."""
    g_list = [int(s) % P for s in g_scalars]
    res = msm(FP.encode(g_list, to_mont=False, device=srs.device), srs.g)
    acc = to_affine_host(PointBatch(*(c[:, None] for c in res)))[0]
    acc = host_jacobian.lincomb([(sc % P, pt) for sc, pt in terms], acc)
    return acc is None  # identity = None in affine host form


def verify_open(srs: SRS, tr: TranscriptReader, commitment: AffinePoint,
                x: int, v: int) -> bool:
    """Verify an IPA opening."""
    g_scalars, terms = verify_open_deferred(srs, tr, commitment, x, v)
    return check_deferred(srs, g_scalars, terms)


def pass_widths(cols: int, commit_chunk: int = COMMIT_CHUNK) -> list[int]:
    """The column counts of `commit_many`'s MSM passes over `cols` vectors:
    `commit_chunk` at most each, padded to a power of two (at least 4)."""
    widths = []
    for lo in range(0, cols, commit_chunk):
        target = 4
        while target < min(commit_chunk, cols - lo):
            target *= 2
        widths.append(target)
    return widths


def commit_many(srs: SRS, coeff_list, blinds=None,
                commit_chunk: int = COMMIT_CHUNK) -> list[AffinePoint]:
    """Commit to many (16, m) Montgomery coefficient vectors in batched
    MSM passes (`pass_widths`); ``blinds[i]`` adds blind·W to commitment i.

    Under a mesh context each entry is this rank's row block (16, 2^k/D)
    of a vector of 2^k coefficients, committed against this rank's block
    of the generators with no gather.  The vector's length is the global
    one, D times the block's, and must be the SRS's: a shorter vector's
    zero pad would move rows between the ranks' blocks.  With no mesh, a
    vector shorter than the SRS is padded with zeros."""
    from ..shard.context import current_mesh

    if not coeff_list:
        return []
    n = srs.n
    mesh = current_mesh()
    padded = []
    for c in coeff_list:
        m = c.shape[-1]
        if mesh is not None:
            if m * mesh.size != n:
                raise ValueError(f"commit_many: blocks of {m} on {mesh.size} "
                                 f"ranks are not vectors of {n}")
        else:
            assert m <= n
            if m < n:
                c = torch.cat([c, FP.zeros((n - m,), c.device)], dim=-1)
        padded.append(c)
    out = []
    for lo, target in zip(range(0, len(padded), commit_chunk),
                          pass_widths(len(padded), commit_chunk)):
        chunk = padded[lo : lo + commit_chunk]
        pad_cols = target - len(chunk)
        if pad_cols:
            chunk = chunk + [chunk[0]] * pad_cols
        stack = torch.stack(chunk, dim=1)  # (16, B, n or n/D)
        res = to_affine_host(_msm_dispatch(FP.from_mont(stack), srs.g,
                                           rows=True))
        out.extend(res[: len(res) - pad_cols] if pad_cols else res)
    if blinds is not None:
        out = [
            host_jacobian.lincomb([(bl % P, srs.w_host)], pt) if bl else pt
            for pt, bl in zip(out, blinds)
        ]
    return out
