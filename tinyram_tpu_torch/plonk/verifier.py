"""PLONKish verifier (host arithmetic plus device NTT/MSM where it pays).

Port of `tinyram_tpu/plonk/verifier.py`; mirrors prover.py phase for phase.
`verify_proof` times its phases into `utils.profiling.counters` as
"verifier.<phase>": instance commitments, transcript and constraint
identity, multiopen fold, IPA check.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from ..curve import host_jacobian
from ..field.field import FP
from ..ipa import SRS
from ..ipa.ipa import commit_many, verify_open, verify_open_deferred
from ..poly.domain import Domain, domain_cache
from ..poly.ntt import eval_poly
from ..transcript import TranscriptReader
from ..utils.profiling import counters
from .expr import evaluate
from .keygen import VerifyingKey, delta
from .protocol import eval_schedule, multiopen_point_order

P = FP.modulus


def _phase(name: str, t0: float) -> float:
    counters.add(f"verifier.{name}", 0, time.time() - t0)
    return time.time()


def _host_eval_expr(expr, evals: dict, x_rotated):
    def var(kind, index, rotation):
        return evals[((kind, index), rotation)]

    return evaluate(
        expr,
        var=var,
        const=lambda v: v % P,
        add=lambda a, b: (a + b) % P,
        mul=lambda a, b: (a * b) % P,
        neg=lambda a: (-a) % P,
    )


def verify_proof(
    srs: SRS, vk: VerifyingKey, instances: list, proof: bytes
) -> bool:
    """True iff ``proof`` is valid for ``instances`` (value lists or
    (16, n) limb arrays, one per instance column)."""
    try:
        return _verify(srs, vk, instances, proof)
    except (ValueError, AssertionError):
        return False


# instance-commitment cache: the TinyRAM verifier re-verifies many proofs
# against the same (program, answer) instance; encoding and committing ~100
# columns is prover-scale work, so cache by the columns' values
_INSTANCE_COMM_CACHE: dict = {}


def _instance_values(inst, n: int):
    """One instance column as host data: an int64 array when its values
    mod p fit in 62 bits (the TinyRAM columns: words, opcodes, flags),
    else a list of ints mod p; a (16, n) limb array stays a tensor."""
    if not isinstance(inst, (list, tuple)):
        return torch.as_tensor(inst)
    assert len(inst) == n
    vals = [int(v) % P for v in inst]
    if max(vals, default=0) < 1 << 62:
        return np.asarray(vals, dtype=np.int64)
    return vals


def _instance_commitments(srs: SRS, dom: Domain, columns: list):
    h = hashlib.sha256()
    h.update(f"{srs.k}:{srs.device}".encode())
    for col in columns:
        if isinstance(col, torch.Tensor):
            h.update(b"limbs" + col.cpu().numpy().tobytes())
        elif isinstance(col, np.ndarray):
            h.update(b"int64" + col.tobytes())
        else:
            h.update(b"ints" + repr(col).encode())
    key = h.hexdigest()
    if key not in _INSTANCE_COMM_CACHE:
        inst_lag = [
            col.to(srs.device) if isinstance(col, torch.Tensor)
            else FP.encode(col, device=srs.device)
            for col in columns
        ]
        inst_stack = dom.lagrange_to_coeff(torch.stack(inst_lag, dim=1))
        inst_coeff = [inst_stack[:, i] for i in range(len(inst_lag))]
        _INSTANCE_COMM_CACHE[key] = (inst_coeff, commit_many(srs, inst_coeff))
        while len(_INSTANCE_COMM_CACHE) > 64:
            _INSTANCE_COMM_CACHE.pop(next(iter(_INSTANCE_COMM_CACHE)))
    return _INSTANCE_COMM_CACHE[key]


def _verify(
    srs: SRS, vk: VerifyingKey, instances: list, proof: bytes,
    defer: list | None = None,
) -> bool:
    cs = vk.cs
    n = 1 << vk.k
    dev = srs.device
    dom = domain_cache("Fp", vk.k, vk.extended_k, dev)
    tr = TranscriptReader(proof)
    vk.absorb_into(tr)
    t0 = time.time()

    # instance commitments (computed, not read)
    columns = [_instance_values(inst, n) for inst in instances]
    assert len(columns) == cs.num_instance
    if columns:
        inst_coeff, inst_comms = _instance_commitments(srs, dom, columns)
        for c in inst_comms:
            tr.common_point(c)
    else:
        inst_coeff = []
    t0 = _phase("instance commitments", t0)

    advice_comms = [tr.read_point() for _ in range(cs.num_advice)]
    theta = tr.challenge()
    lookup_comms = [
        (tr.read_point(), tr.read_point()) for _ in range(len(cs.lookups))
    ]
    rm_comms = [tr.read_point() for _ in range(len(cs.range_lookups))]
    beta = tr.challenge()
    gamma = tr.challenge()
    perm_cols = vk.perm_columns
    zperm_comm = tr.read_point() if perm_cols else None
    lz_comms = [tr.read_point() for _ in range(len(cs.lookups))]
    # per range lookup: h_0..h_{B-1}, h_T, z (canonical order, prover 4b)
    range_comms = [
        (
            [tr.read_point() for _ in range(len(rl.batches()))],
            tr.read_point(),
            tr.read_point(),
        )
        for rl in cs.range_lookups
    ]
    y = tr.challenge()
    n_chunks = 1 << (vk.extended_k - vk.k)
    q_comms = [tr.read_point() for _ in range(n_chunks)]
    x = tr.challenge()

    omega = dom.omega
    points = {
        0: x % P,
        1: x * omega % P,
        -1: x * pow(omega, P - 2, P) % P,
    }
    slots = eval_schedule(cs, len(perm_cols), n_chunks)
    evals: dict[tuple, int] = {}
    for slot in slots:
        if slot.opened:
            evals[(slot.pid, slot.rotation)] = tr.read_scalar()
        else:
            kind, i = slot.pid
            assert kind == "instance"
            zd = FP.encode([points[slot.rotation]], device=dev)[:, 0]
            evals[(slot.pid, slot.rotation)] = FP.decode(
                eval_poly(FP, inst_coeff[i], zd)[:, None]
            )[0]

    # ---- constraint identity at x (canonical constraint order) ----
    constraints: list[int] = []
    for g in cs.gates:
        for poly in g.polys:
            constraints.append(_host_eval_expr(poly, evals, points))
    zh_x = (pow(x, n, P) - 1) % P
    l0_x = zh_x * pow(n * (x - 1) % P, P - 2, P) % P
    # usable-rows selectors (mirror prover): l_last = l_u, active = 1 − Σ_{i≥u}
    u = cs.usable_rows(n)
    tail = dom.lagrange_evals_host(x, range(u, n))
    l_last_x = tail[0]
    active_x = (1 - sum(tail)) % P
    if perm_cols:
        z_x = evals[(("zperm",), 0)]
        z_wx = evals[(("zperm",), 1)]
        constraints.append(l0_x * (z_x - 1) % P)
        constraints.append(l_last_x * (z_x * z_x - z_x) % P)
        d = delta()
        # mirror prover: Z(ωX)·Π(v+β·σ+γ) − Z(X)·Π(v+β·δ^j·X+γ)
        left, right = z_wx, z_x
        for j, col in enumerate(perm_cols):
            vj = evals[((col.kind, col.index), 0)]
            sig = evals[(("sigma", j), 0)]
            left = left * ((vj + beta * sig + gamma) % P) % P
            right = right * ((vj + beta * pow(d, j, P) % P * x + gamma) % P) % P
        constraints.append(active_x * (left - right) % P)
    for li, lk in enumerate(cs.lookups):
        a_x = 0
        for e in reversed(lk.inputs):
            a_x = (a_x * theta + _host_eval_expr(e, evals, points)) % P
        s_x = 0
        for e in reversed(lk.tables):
            s_x = (s_x * theta + _host_eval_expr(e, evals, points)) % P
        # NB: prover's _compress is Horner from the last element, i.e.
        # Σ θ^i v_{…}; mirror exactly (see _compress in prover.py).
        zl_x = evals[(("lz", li), 0)]
        zl_wx = evals[(("lz", li), 1)]
        ap_x = evals[(("la", li), 0)]
        ap_prev = evals[(("la", li), -1)]
        sp_x = evals[(("ls", li), 0)]
        constraints.append(l0_x * (zl_x - 1) % P)
        constraints.append(l_last_x * (zl_x * zl_x - zl_x) % P)
        constraints.append(
            active_x
            * ((zl_wx * ((ap_x + beta) % P) % P * ((sp_x + gamma) % P)
                - zl_x * ((a_x + beta) % P) % P * ((s_x + gamma) % P)) % P)
            % P
        )
        constraints.append(l0_x * (ap_x - sp_x) % P)
        constraints.append(
            active_x * ((ap_x - sp_x) % P) % P * ((ap_x - ap_prev) % P) % P
        )
    for ri, rl in enumerate(cs.range_lookups):
        batches = rl.batches()
        z_x = evals[(("rz", ri), 0)]
        z_wx = evals[(("rz", ri), 1)]
        m_x = evals[(("rm", ri), 0)]
        ht_x = evals[(("rt", ri), 0)]
        h_xs = [evals[(("rh", ri, b), 0)] for b in range(len(batches))]
        constraints.append(l0_x * z_x % P)
        constraints.append(l_last_x * z_x % P)
        constraints.append(
            active_x * ((z_wx - z_x - sum(h_xs) + ht_x) % P) % P
        )
        j0 = 0
        for b, batch in enumerate(batches):
            ds = [
                (beta + _host_eval_expr(rl.inputs[j0 + j], evals, points)) % P
                for j in range(len(batch))
            ]
            j0 += len(batch)
            prod_all = 1
            for dd in ds:
                prod_all = prod_all * dd % P
            excl = 0
            for j in range(len(ds)):
                term = 1
                for l in range(len(ds)):
                    if l != j:
                        term = term * ds[l] % P
                excl = (excl + term) % P
            constraints.append((h_xs[b] * prod_all - excl) % P)
        t_x = _host_eval_expr(rl.table, evals, points)
        constraints.append((ht_x * ((beta + t_x) % P) - m_x) % P)

    folded = constraints[0]
    for c in constraints[1:]:
        folded = (folded * y + c) % P

    q_x = 0
    xn = pow(x, n, P)
    for c in range(n_chunks - 1, -1, -1):
        q_x = (q_x * xn + evals[(("q", c), 0)]) % P
    t0 = _phase("constraint identity", t0)
    if folded != q_x * zh_x % P:
        return False

    # ---- multiopen ----
    commitments: dict[tuple, object] = {}
    for i, cm in enumerate(advice_comms):
        commitments[("advice", i)] = cm
    for i, cm in enumerate(vk.fixed_commitments):
        commitments[("fixed", i)] = cm
    for j, cm in enumerate(vk.sigma_commitments):
        commitments[("sigma", j)] = cm
    if perm_cols:
        commitments[("zperm",)] = zperm_comm
    for li, (ca, cs_) in enumerate(lookup_comms):
        commitments[("la", li)] = ca
        commitments[("ls", li)] = cs_
    for li, cm in enumerate(lz_comms):
        commitments[("lz", li)] = cm
    for ri, cm in enumerate(rm_comms):
        commitments[("rm", ri)] = cm
    for ri, (h_cms, ht_cm, z_cm) in enumerate(range_comms):
        for b, cm in enumerate(h_cms):
            commitments[("rh", ri, b)] = cm
        commitments[("rt", ri)] = ht_cm
        commitments[("rz", ri)] = z_cm
    for c, cm in enumerate(q_comms):
        commitments[("q", c)] = cm

    v = tr.challenge()
    u = tr.challenge()
    rot_order = multiopen_point_order(slots)
    p_group = []  # (rot, commitment, r_val)
    for rot in rot_order:
        group = [s for s in slots if s.opened and s.rotation == rot]
        terms = []
        r_val = 0
        vi = 1
        for s in group:
            terms.append((vi, commitments[s.pid]))
            r_val = (r_val + vi * evals[(s.pid, rot)]) % P
            vi = vi * v % P
        p_group.append((rot, host_jacobian.lincomb(terms), r_val))

    q_comm = tr.read_point()
    zstar = tr.challenge()
    w_vals = [tr.read_scalar() for _ in p_group]
    s_ch = tr.challenge()

    # t_val = Q(z*) + Σ s^{j+1} w_j with Q(z*) from the division identity
    qz = 0
    uj = 1
    for (rot, _, r_val), wv in zip(p_group, w_vals):
        z = points[rot]
        qz = (qz + uj * (wv - r_val) % P * pow((zstar - z) % P, P - 2, P)) % P
        uj = uj * u % P
    t_val = qz
    t_terms = []
    sj = s_ch
    for (rot, cm, _), wv in zip(p_group, w_vals):
        t_val = (t_val + sj * wv) % P
        t_terms.append((sj, cm))
        sj = sj * s_ch % P
    t_comm = host_jacobian.lincomb(t_terms, q_comm)

    t0 = _phase("multiopen fold", t0)
    if defer is not None:
        # batch mode: parse + constraint checks done; hand the IPA check
        # to the accumulator (plonk/batch.py) instead of evaluating it
        defer.append(verify_open_deferred(srs, tr, t_comm, zstar, t_val))
        return tr.finished()
    ok = verify_open(srs, tr, t_comm, zstar, t_val)
    _phase("ipa check", t0)
    return ok and tr.finished()
