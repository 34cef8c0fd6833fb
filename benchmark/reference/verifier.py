"""The plain reference verifier of the port's TinyRAM proofs, in Python
integers and NumPy.

It follows the protocol of the port's verifier (`plonk/verifier.py`, the
transcript layout of `protocol.py`) step for step, with nothing of the
port: the constraint system is the reference's frozen copy
(`tinyram_cs.py`), the SRS its own hash to the curve (`curve.srs`), the
verifying key and the Lagrange commitments its own (`constants.py`), and
the instance columns are built from the program and the answer the
reference emulator computes.  Every commitment enters the final check as
a term of one linear relation, ⟨g, G⟩ + Σ s·P = 0, so several proofs are
checked with one MSM over the generators: a random combination of their
relations (`check`), and, where that fails, each proof by itself, so the
verdict names every proof that fails.
"""

from __future__ import annotations

import secrets

import numpy as np

from . import curve
from .constants import CACHE_DIR, load, path_for
from .expr import evaluate
from .field import P, batch_inverse, inv, omega
from .protocol import eval_schedule, multiopen_point_order
from .tinyram_cs import TinyRamCS, instance_columns
from .transcript import TranscriptReader


class Reject(Exception):
    """The proof fails a check that needs no MSM."""


def _eval_expr(expr, evals: dict):
    return evaluate(
        expr,
        var=lambda kind, index, rotation: evals[((kind, index), rotation)],
        const=lambda v: v % P,
        add=lambda a, b: (a + b) % P,
        mul=lambda a, b: a * b % P,
        neg=lambda a: (-a) % P,
    )


class Verifier:
    """The reference verifier of one configuration (W, registers, k)."""

    def __init__(self, config: dict, config_file: str, pool: int = 1):
        self.pool = pool
        self.tcs = TinyRamCS(config["word_bits"], config["reg_count"],
                             k=config["k"])
        self.cs = self.tcs.cs
        self.k = self.tcs.k
        self.n = 1 << self.k
        self.g, self.u, self.w = curve.srs(self.k, CACHE_DIR, pool)
        self.const = load(path_for(config_file), config["word_bits"],
                          config["reg_count"], self.k, self.g)
        self.extended_k = self.k + self.cs.extension_factor_log2()
        self.omega = omega(self.k)
        self.n_chunks = 1 << (self.extended_k - self.k)
        assert not self.cs.permutation_columns()
        self.slots = eval_schedule(self.cs, 0, self.n_chunks)

    # ------------------------------------------------------------ instance

    def instance(self, prog, answer: int) -> list[np.ndarray]:
        """The instance columns of (program, answer), in column order."""
        by_name = instance_columns(self.tcs, prog, answer)
        out = [None] * self.cs.num_instance
        for name, col in self.tcs.col.instance.items():
            out[col.index] = np.asarray(by_name[name], dtype=np.int64)
        return out

    def _shape(self, col: np.ndarray):
        """A column as (constant over all rows, rows below LINES, the value
        of rows LINES .. table_len-1): the shapes a program's instance
        takes (the answer column is constant; the program's are its lines,
        padded with the last one to the table's end, then zero)."""
        if np.all(col == col[0]):
            return int(col[0]), None, None
        lines, tl = len(self.const.lagrange), self.const.table_len
        tail = col[lines:tl]
        last = int(tail[0]) if len(tail) else 0
        if np.any(col[tl:] != 0) or np.any(tail != last):
            raise ValueError("an instance column outside the shapes the "
                             "reference commits")
        return None, [int(v) for v in col[:lines]], last

    def commit_instance(self, col: np.ndarray):
        const, head, tail = self._shape(col)
        if const is not None:
            return curve.lincomb([(const, self.g[0])])
        terms = list(zip(head, self.const.lagrange))
        terms.append((tail, self.const.tail_sum))
        return curve.lincomb([(v, pt) for v, pt in terms if v])

    def _lagrange_at(self, z: int) -> list[int]:
        """l_i(z) for i < table_len."""
        tl, n = self.const.table_len, self.n
        w_pows = [1] * tl
        for i in range(1, tl):
            w_pows[i] = w_pows[i - 1] * self.omega % P
        scale = (pow(z, n, P) - 1) * inv(n) % P
        dens = batch_inverse([(z - w) % P for w in w_pows])
        return [scale * w % P * d % P for w, d in zip(w_pows, dens)]

    def eval_instance(self, col: np.ndarray, z: int, l_z: list[int]) -> int:
        const, head, tail = self._shape(col)
        if const is not None:
            return const % P
        lines = len(head)
        acc = sum(v * l for v, l in zip(head, l_z[:lines]))
        return (acc + tail * sum(l_z[lines:])) % P

    # ------------------------------------------------------------ proof

    def relation(self, prog, answer: int, proof: bytes):
        """The proof's final check as (g, terms): valid iff ⟨g, G⟩ + Σ s·P
        over the terms is the identity.  Raises `Reject` (or ValueError
        for bytes that are no proof) where a check that needs no MSM
        fails."""
        cs, n = self.cs, self.n
        tr = TranscriptReader(proof)
        for c in self.const.fixed:
            tr.common_point(c)
        columns = self.instance(prog, answer)
        for col in columns:
            tr.common_point(self.commit_instance(col))

        advice_comms = [tr.read_point() for _ in range(cs.num_advice)]
        theta = tr.challenge()
        lookup_comms = [(tr.read_point(), tr.read_point())
                        for _ in range(len(cs.lookups))]
        rm_comms = [tr.read_point() for _ in range(len(cs.range_lookups))]
        beta = tr.challenge()
        gamma = tr.challenge()
        lz_comms = [tr.read_point() for _ in range(len(cs.lookups))]
        range_comms = [([tr.read_point() for _ in range(len(rl.batches()))],
                        tr.read_point(), tr.read_point())
                       for rl in cs.range_lookups]
        y = tr.challenge()
        q_comms = [tr.read_point() for _ in range(self.n_chunks)]
        x = tr.challenge()

        points = {0: x % P, 1: x * self.omega % P,
                  -1: x * inv(self.omega) % P}
        l_at = {}
        evals: dict = {}
        for slot in self.slots:
            if slot.opened:
                evals[(slot.pid, slot.rotation)] = tr.read_scalar()
            else:
                kind, i = slot.pid
                assert kind == "instance"
                z = points[slot.rotation]
                if z not in l_at:
                    l_at[z] = self._lagrange_at(z)
                evals[(slot.pid, slot.rotation)] = self.eval_instance(
                    columns[i], z, l_at[z])

        # the constraint identity at x, in the canonical order
        constraints = [_eval_expr(poly, evals)
                       for g in cs.gates for poly in g.polys]
        zh_x = (pow(x, n, P) - 1) % P
        l0_x = zh_x * inv(n * (x - 1)) % P
        u = cs.usable_rows(n)
        n_inv = inv(n)
        tail = [zh_x * pow(self.omega, i, P) % P * n_inv % P
                * inv(x - pow(self.omega, i, P)) % P for i in range(u, n)]
        l_last_x = tail[0]
        active_x = (1 - sum(tail)) % P
        for li, lk in enumerate(cs.lookups):
            a_x = 0
            for e in reversed(lk.inputs):
                a_x = (a_x * theta + _eval_expr(e, evals)) % P
            s_x = 0
            for e in reversed(lk.tables):
                s_x = (s_x * theta + _eval_expr(e, evals)) % P
            zl_x = evals[(("lz", li), 0)]
            zl_wx = evals[(("lz", li), 1)]
            ap_x = evals[(("la", li), 0)]
            ap_prev = evals[(("la", li), -1)]
            sp_x = evals[(("ls", li), 0)]
            constraints.append(l0_x * (zl_x - 1) % P)
            constraints.append(l_last_x * (zl_x * zl_x - zl_x) % P)
            constraints.append(
                active_x * ((zl_wx * (ap_x + beta) % P * ((sp_x + gamma) % P)
                             - zl_x * ((a_x + beta) % P) % P
                             * ((s_x + gamma) % P)) % P) % P)
            constraints.append(l0_x * (ap_x - sp_x) % P)
            constraints.append(active_x * ((ap_x - sp_x) % P) % P
                               * ((ap_x - ap_prev) % P) % P)
        for ri, rl in enumerate(cs.range_lookups):
            batches = rl.batches()
            z_x = evals[(("rz", ri), 0)]
            z_wx = evals[(("rz", ri), 1)]
            m_x = evals[(("rm", ri), 0)]
            ht_x = evals[(("rt", ri), 0)]
            h_xs = [evals[(("rh", ri, b), 0)] for b in range(len(batches))]
            constraints.append(l0_x * z_x % P)
            constraints.append(l_last_x * z_x % P)
            constraints.append(active_x * ((z_wx - z_x - sum(h_xs) + ht_x) % P)
                               % P)
            j0 = 0
            for b, batch in enumerate(batches):
                ds = [(beta + _eval_expr(rl.inputs[j0 + j], evals)) % P
                      for j in range(len(batch))]
                j0 += len(batch)
                prod_all = 1
                for d in ds:
                    prod_all = prod_all * d % P
                excl = 0
                for j in range(len(ds)):
                    term = 1
                    for m, d in enumerate(ds):
                        if m != j:
                            term = term * d % P
                    excl = (excl + term) % P
                constraints.append((h_xs[b] * prod_all - excl) % P)
            t_x = _eval_expr(rl.table, evals)
            constraints.append((ht_x * ((beta + t_x) % P) - m_x) % P)
        folded = constraints[0]
        for c in constraints[1:]:
            folded = (folded * y + c) % P
        q_x = 0
        xn = pow(x, n, P)
        for c in range(self.n_chunks - 1, -1, -1):
            q_x = (q_x * xn + evals[(("q", c), 0)]) % P
        if folded != q_x * zh_x % P:
            raise Reject("the constraint identity fails at x")

        # the multiopen, with every commitment kept as a term
        comms: dict = {}
        for i, cm in enumerate(advice_comms):
            comms[("advice", i)] = cm
        for i, cm in enumerate(self.const.fixed):
            comms[("fixed", i)] = cm
        for li, (ca, cs_) in enumerate(lookup_comms):
            comms[("la", li)] = ca
            comms[("ls", li)] = cs_
        for li, cm in enumerate(lz_comms):
            comms[("lz", li)] = cm
        for ri, cm in enumerate(rm_comms):
            comms[("rm", ri)] = cm
        for ri, (h_cms, ht_cm, z_cm) in enumerate(range_comms):
            for b, cm in enumerate(h_cms):
                comms[("rh", ri, b)] = cm
            comms[("rt", ri)] = ht_cm
            comms[("rz", ri)] = z_cm
        for c, cm in enumerate(q_comms):
            comms[("q", c)] = cm

        v = tr.challenge()
        u_ch = tr.challenge()
        groups = []  # (rotation, [(scalar, commitment)], r_val)
        for rot in multiopen_point_order(self.slots):
            terms, r_val, vi = [], 0, 1
            for s in self.slots:
                if s.opened and s.rotation == rot:
                    terms.append((vi, comms[s.pid]))
                    r_val = (r_val + vi * evals[(s.pid, rot)]) % P
                    vi = vi * v % P
            groups.append((rot, terms, r_val))
        q_comm = tr.read_point()
        zstar = tr.challenge()
        w_vals = [tr.read_scalar() for _ in groups]
        s_ch = tr.challenge()
        t_val, uj = 0, 1
        for (rot, _, r_val), wv in zip(groups, w_vals):
            t_val = (t_val + uj * (wv - r_val) % P
                     * inv(zstar - points[rot])) % P
            uj = uj * u_ch % P
        t_terms = [(1, q_comm)]
        sj = s_ch
        for (_, terms, _), wv in zip(groups, w_vals):
            t_val = (t_val + sj * wv) % P
            t_terms += [(sj * sc % P, cm) for sc, cm in terms]
            sj = sj * s_ch % P

        # the IPA opening of the folded commitment at z*
        k = self.k
        lrs, us = [], []
        for _ in range(k):
            lrs.append((tr.read_point(), tr.read_point()))
            us.append(tr.challenge())
        a0 = tr.read_scalar()
        xi = tr.read_scalar()
        if not tr.finished():
            raise Reject("bytes left after the proof")
        u_invs = batch_inverse(us)
        s = np.array([1], dtype=object)
        for uu, ui in zip(us, u_invs):
            s = np.concatenate([s * ui % P, s * uu % P])
        t = np.arange(n, dtype=np.int64)
        rt = np.zeros(n, dtype=np.int64)
        for _ in range(k):
            rt = (rt << 1) | (t & 1)
            t >>= 1
        g_scalars = s[rt] * a0 % P
        b0 = 1
        for j, (uu, ui) in enumerate(zip(us, u_invs)):
            b0 = b0 * (ui + uu * pow(zstar, 1 << (k - 1 - j), P)) % P
        terms = [((a0 * b0 - t_val) % P, self.u), (xi % P, self.w)]
        terms += [((P - sc) % P, cm) for sc, cm in t_terms]
        for (L, R), uu, ui in zip(lrs, us, u_invs):
            terms.append(((P - uu * uu) % P, L))
            terms.append(((P - ui * ui) % P, R))
        return g_scalars, terms

    def _holds(self, relations: list) -> bool:
        """Whether a random combination of the relations holds (one MSM
        over the generators and every term)."""
        g_total = np.zeros(self.n, dtype=object)
        extra = []
        for g_scalars, terms in relations:
            r = secrets.randbelow(P - 1) + 1
            g_total = (g_total + g_scalars * r) % P
            extra += [(sc * r % P, pt) for sc, pt in terms if pt is not None]
        scalars = [int(v) for v in g_total] + [sc for sc, _ in extra]
        points = list(self.g) + [pt for _, pt in extra]
        return curve.msm(scalars, points, self.pool) is None

    def check(self, items: list) -> list[str]:
        """For each (program, answer, proof) in `items`, "" if the proof is
        valid for the program's instance with that answer, else why not."""
        verdicts, relations, where = [], [], []
        for prog, answer, proof in items:
            try:
                relations.append(self.relation(prog, answer, proof))
                where.append(len(verdicts))
                verdicts.append("")
            except (Reject, ValueError, AssertionError) as e:
                verdicts.append(f"{type(e).__name__}: {e}")
        if relations and not self._holds(relations):
            for i, rel in zip(where, relations):
                if len(relations) == 1 or not self._holds([rel]):
                    verdicts[i] = "the opening's MSM check fails"
        return verdicts
