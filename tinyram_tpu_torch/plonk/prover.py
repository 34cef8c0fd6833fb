"""PLONKish prover: `create_proof` in PyTorch.

Port of `tinyram_tpu/plonk/prover.py`, with its mesh branch: with
`mesh=`, every rank of the mesh runs this same prover under the mesh
context, so the domain transforms become the all-to-all sharded NTT and
the commit and IPA MSMs point-sharded partials (`shard/`).  Every
coefficient column stays as the rank's row block (n/D rows) from the
transform that makes it to its last use, as the JAX prover's
`ntt_sharded` outputs stay block-sharded (`tinyram_tpu/shard/ntt.py:
118-122`): the commitments take the blocks against the rank's block of
the generators, the quotient phase (`quotient_coeff`) lifts them to its
n_ext/D rows of every extended column (rotations by halo exchange), the
evaluations sum the blocks' partials over the ranks.  What stays whole on
every rank is what the JAX layout has whole: the Lagrange columns (the
assignment, the compressed lookups, the grand products, the quotient's
chunks), what goes to the host or the transcript, the quotient's
coefficients (one gather) and the one polynomial the IPA opens (one
gather).  Same protocol, same transcript traffic, same order of random
draws: the only randomness is `rng.randbelow` (the `secrets` module by
default), so a seeded `rng` reproduces the reference's proof bytes under
the same seeded `secrets.randbelow`.  Under a mesh, rank 0 draws from `rng` and
broadcasts each batch (`shard.mesh.MeshRng`), so every rank returns the
single-device bytes.

The reference compiles each constraint block into one XLA program; here
every block is evaluated eagerly, one field operation per call (kernel B1
for every multiply on a CUDA device).  Its memory knobs are keyword
arguments with the reference's defaults: `ext_chunk` (columns per coset
NTT call), `gate_slab` (gate polynomials per quotient block),
`commit_chunk` (columns per batched MSM) and `eval_slab` (columns a stack
holds in the evaluations and in the multiopen fold).  The quotient lifts its blocks
to the whole extended coset where the widest block fits in the device's
free memory (`utils.device.free_bytes`), and else one coset of the
extended domain at a time, a quarter of the whole lift's transient at
degree 4 (`quotient_coeff`).  The assignment's instance and
advice columns are brought to the device for each use, a chunk at a time
(`_Lagrange`), so an assignment stored in host memory
(`Assignment(host=True)`) never rests on the card whole; only their
coefficients stay there.  These are what let config 4 (k = 21) prove on
one 80 GiB card (`tinyram/prove_config.py` `SIZING`).  Its algorithm
switches are keyword arguments too: `ntt_method="mxu"` (the reference's
`TINYRAM_NTT=mxu`: the domain transforms run the digit-matmul NTT, kernel
M1) and `msm_affine=True`
(`TINYRAM_MSM_AFFINE=1`: the commitments' and opening rounds' Pippenger
MSMs run the batched-affine bucket scan, kernel A1), through the context
of `utils/algorithms.py`; the mesh branches keep their algorithms.  The
seven phases of the reference, and the interpolation of the instance and
advice columns before them, are timed into `utils.profiling.counters` as
"prover.<phase>" and recorded as spans (`utils.profiling.span`), with leaf
spans inside them: "ntt" (the domain transforms), "msm" (the commitments,
`ipa/ipa.py`), "lookup.*", "grand.products", "quotient.eval", "open.*" and
the IPA's "ipa.*".
"""

from __future__ import annotations

import secrets
import time

import torch

from .. import kernels
from ..field.field import FP
from ..field.params import N_LIMBS
from ..ipa import SRS
from ..ipa.ipa import COMMIT_CHUNK, commit, commit_many, open_poly
from ..poly.ntt import _mont_table, eval_poly_rows, tree_sum
from ..transcript import TranscriptWriter
from ..utils.algorithms import algorithms
from ..utils.device import free_bytes
from ..utils.profiling import counters, log as span_log, span
from .circuit import Assignment, pinned
from .expr import batched_evaluate, queried_vars
from .keygen import ProvingKey, delta
from .lookup_rank import logup_counts, plookup_sources
from .protocol import eval_schedule, multiopen_point_order

P = FP.modulus
EXT_CHUNK = 64  # coset-NTT columns per call (reference default)
GATE_SLAB = 48  # gate polynomials per quotient block (reference default)
EVAL_SLAB = 64  # columns per batched evaluation and per multiopen fold


PHASES = ("interpolate instance+advice", "commit instance+advice",
          "lookup permute+commit", "grand products", "constraint ext eval",
          "quotient+commit", "evaluations", "multiopen+ipa")


class _Phases:
    """Records each prover phase of `PHASES`, in order, into `counters` as
    "prover.<name>": its wall time on `time.perf_counter` once the device
    has finished, and (as its op count) the kernel launches it made; under
    a mesh, each collective kind that moved in the phase as
    "prover.<name>/<kind>" (the field elements this rank sent and their
    seconds, `shard/mesh.py`); `hook(name, seconds, launches)` is called
    after each phase if given.  While spans record, each phase is the span
    "prover.<name>", and the spans inside it carry its name
    (`utils.profiling`).  A context manager: the first phase starts on
    entry, and leaving clears the running phase."""

    def __init__(self, device, hook=None):
        self.device = device
        self.hook = hook
        self._names = iter(PHASES)

    def __enter__(self):
        self._start()
        return self

    def __exit__(self, *exc):
        span_log.phase = None
        return False

    def _start(self):
        self.name = next(self._names, None)
        span_log.phase = None if self.name is None else f"prover.{self.name}"
        self.t0 = time.perf_counter()
        self.l0 = kernels.total_launches()
        self.m0 = counters.snapshot("mesh.")

    def end(self, name: str) -> None:
        if name != self.name:
            raise RuntimeError(f"prover phase {name!r} ended during "
                               f"{self.name!r}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        dt, launches = t1 - self.t0, kernels.total_launches() - self.l0
        span_log.phase = None
        if span_log.on():
            span_log.record(f"prover.{name}", self.t0, t1)
        counters.add(f"prover.{name}", launches, dt)
        for key, (ops, secs) in counters.snapshot("mesh.").items():
            ops0, secs0 = self.m0.get(key, (0, 0.0))
            if ops != ops0 or secs != secs0:
                counters.add(f"prover.{name}/{key[len('mesh.'):]}",
                             ops - ops0, secs - secs0)
        if self.hook is not None:
            self.hook(name, dt, launches)
        self._start()


# --------------------------------------------------------------------- utils


def _scan(op, arr: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of a field op along the last axis (log-depth)."""
    d = 1
    n = arr.shape[-1]
    while d < n:
        arr = torch.cat([arr[..., :d], op(arr[..., d:], arr[..., :-d])], dim=-1)
        d *= 2
    return arr


def _prefix_prod_exclusive(arr: torch.Tensor) -> torch.Tensor:
    """[1, a0, a0·a1, …] along the last axis (Montgomery)."""
    inc = _scan(FP.mul, arr)
    ones = FP.ones(arr.shape[1:-1] + (1,), arr.device)
    return torch.cat([ones, inc[..., :-1]], dim=-1)


def _grand_product(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """z[i] = Π_{t<i} num[t]/den[t]  (z[0] = 1), batched over leading axes."""
    return FP.mul(_prefix_prod_exclusive(num),
                  FP.inv(_prefix_prod_exclusive(den)))


def _prefix_sum_exclusive(arr: torch.Tensor) -> torch.Tensor:
    """[0, a0, a0+a1, …] along the last axis of (16, n)."""
    inc = _scan(FP.add, arr)
    zero = FP.zeros(arr.shape[1:-1] + (1,), arr.device)
    return torch.cat([zero, inc[..., :-1]], dim=-1)


class _Roll:
    """`roll(x, shift)`: the rows of x rotated so that row i holds row
    i + shift of the column (`torch.roll(x, -shift)`).  With no mesh x is
    the whole column; with a mesh it is this rank's row block, and the rows
    past the block come by halo exchange (`shard/rows.py` `rolled`, a
    collective every rank issues in the same order)."""

    def __init__(self, mesh=None):
        self.mesh = mesh

    def __call__(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        if shift == 0:
            return x
        if self.mesh is None:
            return torch.roll(x, -shift, dims=-1)
        from ..shard.rows import rolled

        return rolled(self.mesh, x, shift)


_WHOLE = _Roll()  # whole columns: torch.roll


def _eval_exprs_on(exprs, get_col, scale: int = 1, cache: dict | None = None,
                   roll: _Roll = _WHOLE):
    """Evaluate expressions over column tensors with rotation rolls,
    structurally identical expressions once over stacked columns.  The
    columns are rolled in the order `batched_evaluate` visits the
    expressions' variables, the same on every rank of a mesh."""
    roll_cache = {} if cache is None else cache
    device = None

    def slot_value(v):
        nonlocal device
        key = (v.kind, v.index, v.rotation)
        if key not in roll_cache:
            roll_cache[key] = roll(get_col(v.kind, v.index),
                                   v.rotation * scale)
        device = roll_cache[key].device
        return roll_cache[key]

    def stack(vals):
        return torch.stack(vals, dim=1)  # (16, B, n)

    def const(v):
        return FP.const(v, 2, device)  # (16, 1, 1)

    outs = batched_evaluate(
        exprs, slot_value=slot_value, const=const,
        add=FP.add, mul=FP.mul, neg=FP.neg, stack=stack,
    )
    return [res[:, gi] for (res, gi, _) in outs]


def _compress(vals: list[torch.Tensor], th: torch.Tensor) -> torch.Tensor:
    """Σ θ^i v_i (Horner) with θ a (16, 1) Montgomery scalar."""
    acc = vals[-1]
    for v in reversed(vals[:-1]):
        acc = FP.add(FP.mul(acc, th), v)
    return acc


def _vars(exprs) -> list:
    """The sorted (kind, index) columns that expressions query."""
    return sorted({(v.kind, v.index) for v in queried_vars(exprs)})


class _Lift:
    """Where `quotient_coeff` evaluates a block: on the whole extended
    coset g·H_ext (`coset` None: this rank's n_ext/D rows of it), or on
    its coset j, g·ω_ext^j·H, whose n points are the whole's rows
    t = scale·i + j (this rank's n/D rows of it under a mesh).  On a
    coset a rotation by r rows of the circuit is a roll by r (`rot` 1,
    `scale` on the whole), the extended tables are the whole tables' rows
    t ≡ j (mod scale), and each expression chunk lifts only the columns
    it reads (`getter_for`), so a block's transient is a coset's share of
    a chunk's columns."""

    def __init__(self, dom, ext_chunk: int, coset: int | None = None):
        self.dom = dom
        self.ext_chunk = ext_chunk
        self.coset = coset
        self.rot = dom.n_ext // dom.n if coset is None else 1

    def one(self, col: torch.Tensor) -> torch.Tensor:
        """Coefficients (16, ..., n/D) -> their evaluations (this rank's
        rows) on the whole coset or on coset j."""
        with span("ntt"):
            if self.coset is None:
                return self.dom.coeff_to_extended_rows(col)
            return self.dom.coeff_to_coset_rows(col, self.coset)

    def table(self, whole) -> torch.Tensor:
        """This rank's rows of a whole extended table (host or device)."""
        if self.coset is None:
            return self.dom.ext_table_rows(whole)
        return self.dom.coset_rows(whole, self.coset)

    def many(self, cols: list) -> torch.Tensor:
        """Coefficient columns -> (16, V, rows) evaluations, at most
        `ext_chunk` columns per NTT call, written into one stack."""
        out = None
        for lo in range(0, len(cols), self.ext_chunk):
            part = self.one(torch.stack(cols[lo : lo + self.ext_chunk], dim=1))
            if lo == 0 and len(cols) <= self.ext_chunk:
                return part
            if out is None:
                out = part.new_empty(part.shape[:1] + (len(cols),)
                                     + part.shape[2:])
            out[:, lo : lo + part.shape[1]] = part
            del part
        return out

    def getter(self, coeff: dict, vars_: list):
        """get_col(kind, index) over the lifted columns `vars_`."""
        ext = self.many([coeff[v] for v in vars_])
        pos = {v: i for i, v in enumerate(vars_)}
        return lambda kind, index: ext[:, pos[(kind, index)]]

    def getter_for(self, coeff: dict, exprs: list):
        """getter_for(sub) -> get_col for a chunk `sub` of `exprs`: on the
        whole coset one lift of every column `exprs` reads (the block's
        columns alive together), on a coset a lift of the chunk's own."""
        if self.coset is not None:
            return lambda sub: self.getter(coeff, _vars(sub))
        whole = self.getter(coeff, _vars(exprs))
        return lambda sub: whole


def _l2c_chunked(dom, lag, pids: list, ext_chunk: int) -> torch.Tensor:
    """Batched lagrange->coeff of the whole Lagrange columns `lag[pid]`,
    `ext_chunk` per call, written into one stack (16, B, n/D): this rank's
    row block of their coefficients under a mesh
    (`Domain.lagrange_to_coeff_rows` of the rank's block of each column,
    no gather), the whole without.  Only a chunk of the Lagrange columns
    is on the device at a time (`lag` may fetch them from the host)."""
    with span("ntt"):
        out = None
        for lo in range(0, len(pids), ext_chunk):
            part = dom.lagrange_to_coeff_rows(torch.stack(
                [dom.block(lag[pid]) for pid in pids[lo : lo + ext_chunk]],
                dim=1))
            if lo == 0 and len(pids) <= ext_chunk:
                return part
            if out is None:
                out = part.new_empty(part.shape[:1] + (len(pids),)
                                     + part.shape[2:])
            out[:, lo : lo + part.shape[1]] = part
            del part
        return out


def _fold(constraints: list, w: torch.Tensor, rows: int) -> torch.Tensor:
    """Σ_i w_i · constraint_i for (16, rows) constraints, w (16, S, 1)."""
    c_stack = torch.stack(
        [c.expand(16, rows) for c in constraints], dim=1
    )
    return tree_sum(FP, FP.mul(c_stack, w), axis=1)


def _theta_powers(th: torch.Tensor, count: int) -> list:
    pows = [FP.ones((1,), th.device)]
    for _ in range(count - 1):
        pows.append(FP.mul(pows[-1], th))
    return pows


def _compress_exprs_chunked(exprs, th, getter_for, scale: int, rows: int,
                            roll: _Roll, chunk: int = 8) -> torch.Tensor:
    """Σ_i θ^i·expr_i on the extended domain (`rows` of it), `chunk`
    expressions at once, each chunk's columns from `getter_for(chunk)`."""
    B = len(exprs)
    if B == 1:
        return _eval_exprs_on(exprs, getter_for(exprs), scale, {}, roll)[0]
    pows = _theta_powers(th, B)
    acc = None
    for lo in range(0, B, chunk):
        sub = exprs[lo : lo + chunk]
        vals = _eval_exprs_on(sub, getter_for(sub), scale, {}, roll)
        w = torch.stack([pows[lo + j] for j in range(len(sub))], dim=1)
        part = _fold(vals, w, rows)
        del vals
        acc = part if acc is None else FP.add(acc, part)
    return acc


def _gate_blocks(cs, slab: int):
    """[(exprs, sorted queried (kind, index) list)] per gate slab."""
    all_polys = [p for g in cs.gates for p in g.polys]
    return [(all_polys[lo : lo + slab], _vars(all_polys[lo : lo + slab]))
            for lo in range(0, len(all_polys), slab)]


def _lookup_fold(lk, li, lift: _Lift, coeff, tables, theta, beta, gamma, w,
                 roll: _Roll):
    """The five plookup rules of lookup `li`, y-weighted, on the rows of
    `tables` (16, 3, rows)."""
    rows = tables.shape[-1]
    scale = lift.rot
    getter_for = lift.getter_for(coeff, lk.inputs + lk.tables)
    aext = lift.many([coeff[("la", li)], coeff[("ls", li)],
                      coeff[("lz", li)]])
    l0, l_last, active = tables[:, 0], tables[:, 1], tables[:, 2]
    a_ext = _compress_exprs_chunked(lk.inputs, theta, getter_for, scale, rows,
                                    roll)
    s_ext = _compress_exprs_chunked(lk.tables, theta, getter_for, scale, rows,
                                    roll)
    del getter_for
    ap, sp, zl = aext[:, 0], aext[:, 1], aext[:, 2]
    zl_next = roll(zl, scale)
    ap_prev = roll(ap, -scale)
    one = FP.ones((rows,), tables.device)
    constraints = [
        FP.mul(l0, FP.sub(zl, one)),
        FP.mul(l_last, FP.sub(FP.mul(zl, zl), zl)),
        FP.mul(
            active,
            FP.sub(
                FP.mul(zl_next, FP.mul(FP.add(ap, beta), FP.add(sp, gamma))),
                FP.mul(zl, FP.mul(FP.add(a_ext, beta), FP.add(s_ext, gamma))),
            ),
        ),
        FP.mul(l0, FP.sub(ap, sp)),
        FP.mul(active, FP.mul(FP.sub(ap, sp), FP.sub(ap, ap_prev))),
    ]
    return _fold(constraints, w, rows)


def _range_fold(rl, ri, lift: _Lift, coeff, tables, beta, w, roll: _Roll):
    """The LogUp rules of range lookup `ri`, y-weighted, on the rows of
    `tables` (16, 3, rows), in the verifier's order [l0·z, l_last·z,
    z-diff, batch_0 … batch_{B-1}, tail], from the coefficients of m,
    h_T, z, h_0 … h_{B-1}."""
    rows = tables.shape[-1]
    scale = lift.rot
    batches = rl.batches()
    nb = len(batches)
    aext = lift.many([coeff[("rm", ri)], coeff[("rt", ri)], coeff[("rz", ri)]]
                     + [coeff[("rh", ri, b)] for b in range(nb)])
    l0, l_last, active = tables[:, 0], tables[:, 1], tables[:, 2]
    m_ext, ht_ext, z = aext[:, 0], aext[:, 1], aext[:, 2]
    h_exts = [aext[:, 3 + b] for b in range(nb)]
    z_next = roll(z, scale)
    sum_h = h_exts[0]
    for hh in h_exts[1:]:
        sum_h = FP.add(sum_h, hh)
    acc = _fold(
        [
            FP.mul(l0, z),
            FP.mul(l_last, z),
            FP.mul(active, FP.sub(FP.sub(z_next, z), FP.sub(sum_h, ht_ext))),
        ],
        w[:, 0:3], rows,
    )
    one = FP.ones((rows,), tables.device)
    j0 = 0
    for b, batch in enumerate(batches):
        exprs = rl.inputs[j0 : j0 + len(batch)]
        j0 += len(batch)
        vals = _eval_exprs_on(exprs, lift.getter(coeff, _vars(exprs)), scale,
                              {}, roll)
        ds = [FP.add(v, beta) for v in vals]
        del vals
        prod_all = ds[0]
        for dd in ds[1:]:
            prod_all = FP.mul(prod_all, dd)
        excl = None
        for j in range(len(ds)):
            term = None
            for l in range(len(ds)):
                if l == j:
                    continue
                term = ds[l] if term is None else FP.mul(term, ds[l])
            if term is None:  # batch of one
                term = one
            excl = term if excl is None else FP.add(excl, term)
        c = FP.sub(FP.mul(h_exts[b], prod_all), excl)
        acc = FP.add(acc, FP.mul(c, w[:, 3 + b]))
    t_ext = _eval_exprs_on([rl.table], lift.getter(coeff, _vars([rl.table])),
                           scale, {}, roll)[0]
    c = FP.sub(FP.mul(ht_ext, FP.add(t_ext, beta)), m_ext)
    return FP.add(acc, FP.mul(c, w[:, 3 + nb]))


def _widest_block(cs, gate_slab: int) -> int:
    """The most coefficient columns one block of `quotient_coeff` lifts
    together to the whole extended coset: a gate slab's, the permutation's
    (its columns, their sigmas and z), a lookup's inputs and tables with
    its three columns, a LogUp argument's inputs and table with its own."""
    widths = [len(v) for _, v in _gate_blocks(cs, gate_slab)]
    perm = cs.permutation_columns()
    if perm:
        widths.append(2 * len(perm) + 1)
    widths += [len(_vars(lk.inputs + lk.tables)) + 3 for lk in cs.lookups]
    widths += [len(_vars(rl.inputs + [rl.table])) + 3 + len(rl.batches())
               for rl in cs.range_lookups]
    return max(widths, default=0)


def _lift_whole(cs, dom, gate_slab: int, mesh) -> bool:
    """Whether `quotient_coeff` lifts its blocks to the whole extended
    coset: where twice the widest block's lifted columns (its expressions'
    temporaries are of the same order) fit in the device's free memory,
    always where none is observed (the CPU).  Under a mesh on the card,
    every rank takes rank 0's choice, so that their halo exchanges pair."""
    rows = dom.n_ext // (1 if mesh is None else mesh.size)
    need = 2 * _widest_block(cs, gate_slab) * N_LIMBS * 4 * rows
    free = free_bytes(dom.device)
    whole = free is None or need <= free
    if mesh is not None and dom.device.type == "cuda":
        whole = bool(mesh.broadcast_ints(
            [int(whole)] if mesh.rank == 0 else None, 1, n_bytes=1)[0])
    return whole


def quotient_coeff(cs, dom, coeff: dict, challenges: tuple, u: int,
                   perm_cols: list, ext_chunk: int = EXT_CHUNK,
                   gate_slab: int = GATE_SLAB,
                   on_folded=None) -> torch.Tensor:
    """Phase 5 of `create_proof`: the quotient's coefficients (16, n_ext),
    whole on every rank, from the coefficient columns `coeff` (pid -> this
    rank's row block (16, n/D) under a mesh context, the whole (16, n)
    without) and the challenges (θ, β, γ, y).

    Constraint blocks (gate slabs, the permutation, each lookup, each LogUp
    argument) take their columns in the coefficient domain and lift them to
    the extended coset themselves, so at most one block's extended columns
    are alive at a time.  Where the widest block's whole lift does not fit
    in the device's free memory (`_lift_whole`: config 4's `prog` lookup
    would take ~195 GiB), every block is evaluated on one coset
    g·ω_ext^j·H of the extended domain at a time (`_Lift`), and the folded
    cosets are interleaved into the extended domain's order
    (t = scale·i + j): the same values, with a block's transient cut by
    the scale (4× at degree 4) and each expression chunk's columns lifted
    alone.  Under a mesh context each rank lifts and holds
    only its rows of every extended column and table
    (`Domain.coeff_to_extended_rows` or `coeff_to_coset_rows`,
    `ext_table_rows` or `coset_rows`),
    every rotation is a halo exchange (`_Roll`), and the only gather is of
    the quotient's coefficients after the inverse transform
    (`extended_rows_to_coeff`), as GSPMD keeps the JAX prover's quotient
    phase on row blocks (`tinyram_tpu/plonk/prover.py:577-592`).  With no
    mesh every block is the whole column.  `on_folded(acc)` is called with
    the folded constraints (this rank's rows) before the division by
    Z_H."""
    from ..shard.context import current_mesh

    theta, beta, gamma, y = challenges
    dev = dom.device
    scale = dom.n_ext // dom.n
    roll = _Roll(current_mesh())

    def const(v: int) -> torch.Tensor:
        return FP.const(v, 1, dev)  # (16, 1)

    theta_d, beta_d, gamma_d = const(theta), const(beta), const(gamma)
    all_polys = [p for g in cs.gates for p in g.polys]
    K = (
        len(all_polys)
        + (3 if perm_cols else 0)
        + 5 * len(cs.lookups)
        + sum(4 + len(rl.batches()) for rl in cs.range_lookups)
    )
    y_pows = [pow(y, K - 1 - i, P) for i in range(K)]
    # usable-rows selectors: l_last = l_u; active = 1 − Σ_{i≥u} l_i
    whole_tables = (dom.l0_evals_ext(), dom.lagrange_sum_ext((u,)),
                    dom.lagrange_sum_ext(tuple(range(u, dom.n))))

    def fold(lift: _Lift) -> torch.Tensor:
        """Every block's constraints, y-weighted and summed, on the rows
        of `lift`."""
        l0_ext, l_last_ext, blinding = (lift.table(t) for t in whole_tables)
        rows = l0_ext.shape[-1]
        one_ext = FP.ones((rows,), dev)
        active_ext = FP.sub(one_ext, blinding)
        tables3 = torch.stack([l0_ext, l_last_ext, active_ext], dim=1)
        state = {"acc": None, "i": 0}

        def take_w(count: int) -> torch.Tensor:
            i0 = state["i"]
            state["i"] = i0 + count
            return FP.encode(y_pows[i0 : i0 + count], device=dev)[:, :, None]

        def add_part(part: torch.Tensor):
            state["acc"] = (part if state["acc"] is None
                            else FP.add(state["acc"], part))

        for exprs, vars_ in _gate_blocks(cs, gate_slab):
            outs = _eval_exprs_on(exprs, lift.getter(coeff, vars_), lift.rot,
                                  {}, roll)
            add_part(_fold(outs, take_w(len(exprs)), rows))
            del outs
        if perm_cols:
            ext_c: dict = {}  # filled in program order: the same on every rank

            def ext(pid):
                if pid not in ext_c:
                    ext_c[pid] = lift.one(coeff[pid])
                return ext_c[pid]

            x_ext = lift.table(dom.x_evals_ext())
            constraints = []
            z = ext(("zperm",))
            z_next = roll(z, lift.rot)
            constraints.append(FP.mul(l0_ext, FP.sub(z, one_ext)))
            constraints.append(FP.mul(l_last_ext, FP.sub(FP.mul(z, z), z)))
            d = delta()
            # Z(ωX)·Π(v + β·σ_j + γ) − Z(X)·Π(v + β·δ^j·X + γ) = 0
            left, right = z_next, z
            for j, col in enumerate(perm_cols):
                v = ext((col.kind, col.index))
                dj = pow(d, j, P) * beta % P
                left = FP.mul(
                    left, FP.add(FP.add(v, FP.mul(beta_d, ext(("sigma", j)))),
                                 gamma_d))
                right = FP.mul(
                    right, FP.add(FP.add(v, FP.mul(const(dj), x_ext)),
                                  gamma_d))
            constraints.append(FP.mul(active_ext, FP.sub(left, right)))
            add_part(_fold(constraints, take_w(3), rows))
            del ext_c, constraints, left, right
        for li, lk in enumerate(cs.lookups):
            add_part(_lookup_fold(lk, li, lift, coeff, tables3, theta_d,
                                  beta_d, gamma_d, take_w(5), roll))
        for ri, rl in enumerate(cs.range_lookups):
            add_part(_range_fold(rl, ri, lift, coeff, tables3, beta_d,
                                 take_w(4 + len(rl.batches())), roll))
        assert state["i"] == K, (state["i"], K)
        return state["acc"]

    with span("quotient.eval"):  # the lifts inside are "ntt" spans
        if _lift_whole(cs, dom, gate_slab, current_mesh()):
            acc = fold(_Lift(dom, ext_chunk))
        else:
            acc = None
            for j in range(scale):
                part = fold(_Lift(dom, ext_chunk, j))
                if acc is None:
                    acc = part.new_empty(part.shape[:-1]
                                         + (part.shape[-1] * scale,))
                acc.view(part.shape[:-1]
                         + (part.shape[-1], scale))[..., j] = part
                del part
    if on_folded is not None:
        on_folded(acc)
    with span("quotient.eval"):
        acc = dom.divide_by_vanishing(acc)
    with span("ntt"):
        return dom.extended_rows_to_coeff(acc)


# -------------------------------------------------------------------- prover


def create_proof(
    srs: SRS, pk: ProvingKey, asg: Assignment,
    tw: TranscriptWriter | None = None, rng=secrets,
    ext_chunk: int = EXT_CHUNK, gate_slab: int = GATE_SLAB,
    commit_chunk: int = COMMIT_CHUNK, phase_hook=None, mesh=None,
    ntt_method: str = "b2", msm_affine: bool = False,
    eval_slab: int = EVAL_SLAB,
) -> bytes:
    """The proof of `asg` under `pk`.  `ntt_method` ("b2" or "mxu") and
    `msm_affine` pick the domain transforms' NTT and the commitments' MSM
    bucket scan (`utils/algorithms.py`); every choice and every width
    gives the same bytes."""
    with algorithms(ntt_method, msm_affine):
        return _create_proof(srs, pk, asg, tw, rng, ext_chunk, gate_slab,
                             commit_chunk, phase_hook, mesh, eval_slab)


class _Lagrange(dict):
    """The prover's whole Lagrange columns by pid, each returned on the
    device.  The assignment's instance and advice columns and the key's
    fixed ones are not kept here: `self[pid]` brings one to the device for
    each use (`Assignment.fetch`; the key's may rest on the host,
    `keygen(host=True)`), the advice with its blinding tail (`tails[:, i]`,
    rows u…n−1) written in, so a witness stored on the host never rests on
    the card whole.  `rest()` moves the columns kept here to pinned host
    memory, from where each use fetches them too."""

    def __init__(self, asg: Assignment, pk: ProvingKey, dev, u: int, tails):
        super().__init__()
        self.asg, self.pk, self.dev = asg, pk, dev
        self.u, self.tails = u, tails

    def __getitem__(self, pid):
        col = dict.get(self, pid)
        if col is None:
            return self.fetch(pid)
        return col.to(self.dev, non_blocking=True)

    def fetch(self, pid) -> torch.Tensor:
        if len(pid) != 2 or pid[0] not in ("instance", "advice", "fixed"):
            raise KeyError(pid)
        kind, index = pid
        if kind == "fixed":
            return self.pk.fixed_lag[index].to(self.dev, non_blocking=True)
        stored = getattr(self.asg, kind)[index]
        col = self.asg.fetch(kind, index).to(self.dev)
        if kind == "advice" and self.tails is not None:
            if col is stored:  # a device store: keep the assignment as it is
                col = col.clone()
            col[:, self.u:] = self.tails[:, index]
        return col

    def rest(self) -> None:
        for pid, col in list(self.items()):
            dict.__setitem__(self, pid, pinned(col))


def _create_proof(srs, pk, asg, tw, rng, ext_chunk, gate_slab, commit_chunk,
                  phase_hook, mesh, eval_slab=EVAL_SLAB) -> bytes:
    if mesh is not None:
        # sharded mode: every rank runs this prover on the same inputs
        # under the mesh context (domain transforms and MSMs shard), with
        # rank 0's draws from `rng` broadcast to all ranks
        from ..shard.context import mesh_context
        from ..shard.mesh import MeshRng

        with mesh_context(mesh):
            return _create_proof(srs, pk, asg, tw, MeshRng(mesh, rng),
                                 ext_chunk, gate_slab, commit_chunk,
                                 phase_hook, None, eval_slab)
    with _Phases(pk.domain.device, phase_hook) as phases:
        return _prove(srs, pk, asg, tw, rng, ext_chunk, gate_slab,
                      commit_chunk, eval_slab, phases)


def _prove(srs, pk, asg, tw, rng, ext_chunk, gate_slab, commit_chunk,
           eval_slab, phases: _Phases) -> bytes:
    """`create_proof`'s body on one device (or one rank of the mesh
    context), its phases ended on `phases`."""
    cs = pk.vk.cs
    dom = pk.domain
    dev = dom.device
    n = dom.n
    asg.finalize()
    tw = tw or TranscriptWriter()

    def cm(cols, blinds):  # coefficient row blocks (whole with no mesh)
        return commit_many(srs, cols, blinds=blinds, commit_chunk=commit_chunk)

    def const(v: int) -> torch.Tensor:
        return FP.const(v, 1, dev)  # (16, 1)

    # ---- zero-knowledge blinding rows: rows [u, n) of every advice column
    # get uniform random values; gates vanish there, product rules switch off
    bf = cs.blinding_factors
    u = cs.usable_rows(n)

    def _rand_tail(count: int) -> list[int]:
        if bf == 0:
            return [0] * count
        many = getattr(rng, "randbelow_many", None)  # one batch on a mesh
        if many is not None:
            return many(P, count)
        return [rng.randbelow(P) for _ in range(count)]

    tails = None
    if bf > 0 and cs.num_advice:
        tail = n - u
        tails = FP.encode(_rand_tail(cs.num_advice * tail),
                          device=dev).reshape(16, cs.num_advice, tail)

    lag = _Lagrange(asg, pk, dev, u, tails)
    coeff: dict[tuple, torch.Tensor] = {}
    blinds: dict[tuple, int] = {}  # W-blinds; 0 for public polys

    def _blind(pid):
        blinds[pid] = rng.randbelow(P)
        return blinds[pid]

    # every entry of `coeff` is this rank's row block (16, n/D) under a
    # mesh (the key's whole columns cut here, no collective), the whole
    # column with none; `lag` holds whole Lagrange columns
    for i in range(cs.num_fixed):
        coeff[("fixed", i)] = dom.block(pk.fixed_coeff[i])
    for j in range(len(pk.sigma_lag)):
        lag[("sigma", j)] = pk.sigma_lag[j]
        coeff[("sigma", j)] = dom.block(pk.sigma_coeff[j])
    # (16, B, n/D) under a mesh
    coeff_stack = _l2c_chunked(
        dom, lag, [("instance", i) for i in range(cs.num_instance)]
        + [("advice", i) for i in range(cs.num_advice)], ext_chunk)
    for i in range(cs.num_instance):
        coeff[("instance", i)] = coeff_stack[:, i]
    for i in range(cs.num_advice):
        coeff[("advice", i)] = coeff_stack[:, cs.num_instance + i]

    phases.end("interpolate instance+advice")
    # 1. bind vk + instances + advice (one batched MSM)
    pk.vk.absorb_into(tw)
    all_comms = cm(
        [coeff_stack[:, i] for i in range(coeff_stack.shape[1])],
        [0] * cs.num_instance
        + [_blind(("advice", i)) for i in range(cs.num_advice)],
    )
    for i in range(cs.num_instance):
        tw.common_point(all_comms[i])
    for i in range(cs.num_advice):
        tw.write_point(all_comms[cs.num_instance + i])
    del coeff_stack  # its columns live on in `coeff`

    phases.end("commit instance+advice")
    # 2. lookups: compress, permute, commit A'/S'
    theta = tw.challenge()
    theta_d = const(theta)

    def col_lag(kind, index):
        return lag[(kind, index)]

    def _compress_lag_chunked(exprs, chunk=16):
        """Σ θ^i expr_i on the lagrange domain, in expression chunks."""
        if len(exprs) <= chunk:
            return _compress(_eval_exprs_on(exprs, col_lag, 1, {}), theta_d)
        acc = None
        for lo in range(0, len(exprs), chunk):
            vals = _eval_exprs_on(exprs[lo : lo + chunk], col_lag, 1, {})
            part = _compress(vals, theta_d)
            if lo:
                part = FP.mul(part, const(pow(theta, lo, P)))
            acc = part if acc is None else FP.add(acc, part)
        return acc

    lookup_data = []
    permuted = []
    with span("lookup.compress"):
        for lk in cs.lookups:
            lookup_data.append((_compress_lag_chunked(lk.inputs),
                                _compress_lag_chunked(lk.tables)))
        if lookup_data:
            all_pairs = torch.stack([x for pair in lookup_data for x in pair],
                                    dim=1)
            pairs_plain = FP.from_mont(all_pairs[:, :, :u].contiguous())
            del all_pairs
    if lookup_data:
        # permute over the usable prefix only; the blinding tail is random.
        # The order is decided on the device (`lookup_rank`): A' and S' are
        # gathered from the Montgomery columns held there
        with span("lookup.permute"):
            srcs = plookup_sources(pairs_plain)
        del pairs_plain
        counters.add("lookup.permute.card", len(lookup_data), 0.0)
    for li, (a_lag, s_lag) in enumerate(lookup_data):
        with span("lookup.permute"):
            tail_vals = _rand_tail(2 * (n - u))
            ap_tail = _mont_table(FP, tail_vals[: n - u])
            sp_tail = _mont_table(FP, tail_vals[n - u:])
        with span("lookup.upload"):
            both = torch.cat([a_lag[:, :u], s_lag[:, :u]],
                             dim=1)[:, srcs[li].reshape(-1)]
            ap_lag = torch.cat([both[:, :u], torch.as_tensor(ap_tail, device=dev)],
                               dim=1)
            sp_lag = torch.cat([both[:, u:], torch.as_tensor(sp_tail, device=dev)],
                               dim=1)
        lag[("la", li)] = ap_lag
        lag[("ls", li)] = sp_lag
        permuted += [("la", li), ("ls", li)]
    if lookup_data:  # the last lookup's temporaries (columns of n)
        del a_lag, s_lag, srcs, both, ap_lag, sp_lag
    if permuted:
        perm_coeff = _l2c_chunked(dom, lag, permuted, ext_chunk)
        perm_comms = cm(
            [perm_coeff[:, i] for i in range(perm_coeff.shape[1])],
            [_blind(("la", i // 2) if i % 2 == 0 else ("ls", i // 2))
             for i in range(perm_coeff.shape[1])],
        )
        for li in range(len(cs.lookups)):
            coeff[("la", li)] = perm_coeff[:, 2 * li]
            coeff[("ls", li)] = perm_coeff[:, 2 * li + 1]
            tw.write_point(perm_comms[2 * li])
            tw.write_point(perm_comms[2 * li + 1])
        del perm_coeff

    # 2b. range lookups (LogUp): multiplicity columns committed before β;
    # m[r] counts the usable-row inputs equal to t(r), on the first table
    # row holding each value
    range_data = []  # (in_stack (16,B,n), t_lag (16,n), m_lag (16,n))
    if cs.range_lookups:
        with span("lookup.compress"):  # here: the LogUp inputs and tables
            rl_stacks = []
            for rl in cs.range_lookups:
                in_vals = []
                for lo in range(0, len(rl.inputs), 8):
                    in_vals.extend(
                        _eval_exprs_on(rl.inputs[lo : lo + 8], col_lag, 1, {})
                    )
                t_val = _eval_exprs_on([rl.table], col_lag, 1, {})[0]
                rl_stacks.append((torch.stack(in_vals, dim=1), t_val))
                del in_vals
            all_cols = torch.cat(
                [torch.cat([s, t[:, None]], dim=1) for s, t in rl_stacks],
                dim=1)
            cols_plain = FP.from_mont(all_cols[:, :, :u].contiguous())
            del all_cols
        m_lags = []
        off = 0
        for rl, (in_stack, t_lag) in zip(cs.range_lookups, rl_stacks):
            with span("lookup.multiplicity"):
                nin = in_stack.shape[1]
                in_plain = cols_plain[:, off : off + nin]
                t_plain = cols_plain[:, off + nin]
                off += nin + 1
                m_plain = logup_counts(in_plain, t_plain, rl.name)
            with span("lookup.upload"):
                m_lag = torch.zeros((N_LIMBS, n), dtype=m_plain.dtype,
                                    device=dev)
                m_lag[:, :u] = m_plain
                if bf > 0:
                    m_lag[:, u:] = FP.encode(_rand_tail(n - u), to_mont=False,
                                             device=dev)
                m_lag = FP.to_mont(m_lag)
            m_lags.append(m_lag)
            range_data.append((in_stack, t_lag, m_lag))
        counters.add("lookup.multiplicity.card", len(cs.range_lookups), 0.0)
        del rl_stacks, cols_plain, in_plain, t_plain, m_plain
        with span("ntt"):
            m_coeff = dom.lagrange_to_coeff_rows(
                dom.block(torch.stack(m_lags, dim=1)))
        m_comms = cm(
            [m_coeff[:, i] for i in range(m_coeff.shape[1])],
            [_blind(("rm", ri)) for ri in range(len(cs.range_lookups))],
        )
        for ri in range(len(cs.range_lookups)):
            lag[("rm", ri)] = m_lags[ri]
            coeff[("rm", ri)] = m_coeff[:, ri]
            tw.write_point(m_comms[ri])
        del m_coeff, m_lags, m_lag

    phases.end("lookup permute+commit")
    beta = tw.challenge()
    gamma = tw.challenge()
    beta_d, gamma_d = const(beta), const(gamma)

    # 3. permutation grand product
    perm_cols = pk.vk.perm_columns
    row_mask = torch.arange(n, device=dev) < u
    if perm_cols:
        with span("grand.products"):
            d = delta()
            # X on H
            omega_tbl = torch.as_tensor(dom.omega_powers(), device=dev)
            num = None
            den = None
            for j, col in enumerate(perm_cols):
                v = lag[(col.kind, col.index)]
                dj = pow(d, j, P) * beta % P
                t_num = FP.add(FP.add(v, FP.mul(const(dj), omega_tbl)),
                               gamma_d)
                t_den = FP.add(FP.add(v, FP.mul(beta_d, lag[("sigma", j)])),
                               gamma_d)
                num = t_num if num is None else FP.mul(num, t_num)
                den = t_den if den is None else FP.mul(den, t_den)
            # restrict the product to usable rows; z[u] is the end value
            ones_n = FP.ones((n,), dev)
            zperm = _grand_product(torch.where(row_mask, num, ones_n),
                                   torch.where(row_mask, den, ones_n))
            if bf > 0:
                zperm[:, u + 1 :] = FP.encode(_rand_tail(n - u - 1),
                                              device=dev)
        lag[("zperm",)] = zperm
        with span("ntt"):
            coeff[("zperm",)] = dom.lagrange_to_coeff_rows(dom.block(zperm))
        tw.write_point(commit(srs, coeff[("zperm",)], blind=_blind(("zperm",)),
                              commit_chunk=commit_chunk))

    # 4. lookup grand products (batched across lookups)
    if lookup_data:
        with span("grand.products"):
            nums = torch.stack(
                [FP.mul(FP.add(a_lag, beta_d), FP.add(s_lag, gamma_d))
                 for a_lag, s_lag in lookup_data], dim=1)
            dens = torch.stack(
                [FP.mul(FP.add(lag[("la", li)], beta_d),
                        FP.add(lag[("ls", li)], gamma_d))
                 for li in range(len(cs.lookups))], dim=1)
            ones_b = FP.ones((1, n), dev)
            del lookup_data  # the compressed inputs and tables: read only here
            nums = torch.where(row_mask, nums, ones_b)
            dens = torch.where(row_mask, dens, ones_b)
            zs = _grand_product(nums, dens)
            del nums, dens
            if bf > 0:
                B = zs.shape[1]
                zs[:, :, u + 1 :] = FP.encode(
                    _rand_tail(B * (n - u - 1)), device=dev
                ).reshape(16, B, n - u - 1)
        with span("ntt"):
            z_coeff = dom.lagrange_to_coeff_rows(dom.block(zs))
        z_comms = cm(
            [z_coeff[:, i] for i in range(z_coeff.shape[1])],
            [_blind(("lz", i)) for i in range(z_coeff.shape[1])],
        )
        for li in range(len(cs.lookups)):
            lag[("lz", li)] = zs[:, li]
            coeff[("lz", li)] = z_coeff[:, li]
            tw.write_point(z_comms[li])
        del zs, z_coeff

    # 4b. LogUp helpers + running sums: h_b = Σ_{j∈batch b} 1/(β+f_j),
    # h_T = m/(β+t), z = exclusive prefix sum of (Σ_b h_b − h_T) over
    # usable rows; one batched inversion covers every denominator
    if range_data:
        with span("grand.products"):
            den_list = []
            for in_stack, t_lag, _ in range_data:
                den_list.append(FP.add(in_stack, beta_d[:, :, None]))
                den_list.append(FP.add(t_lag, beta_d)[:, None])
            # the inputs are read only through their denominators from here
            del in_stack
            range_data = [(s.shape[1], t, m) for s, t, m in range_data]
            dens = torch.cat(den_list, dim=1)
            del den_list
            invs = FP.inv(dens)
            del dens
            pids_order = []  # canonical commit order: per rl h_0.., h_T, z
            cols = []
            off = 0
            for ri, (nin, t_lag, m_lag) in enumerate(range_data):
                rl = cs.range_lookups[ri]
                inv_in = invs[:, off : off + nin]
                inv_t = invs[:, off + nin]
                off += nin + 1
                h_lags = []
                j0 = 0
                for batch in rl.batches():
                    h_lags.append(
                        tree_sum(FP, inv_in[:, j0 : j0 + len(batch)], axis=1)
                    )
                    j0 += len(batch)
                h_t = FP.mul(m_lag, inv_t)
                contrib = h_lags[0]
                for h in h_lags[1:]:
                    contrib = FP.add(contrib, h)
                contrib = FP.sub(contrib, h_t)
                contrib = torch.where(row_mask, contrib, FP.zeros((n,), dev))
                z = _prefix_sum_exclusive(contrib)
                if bf > 0:
                    z[:, u + 1 :] = FP.encode(_rand_tail(n - u - 1),
                                              device=dev)
                for b, h in enumerate(h_lags):
                    pids_order.append(("rh", ri, b))
                    cols.append(h)
                pids_order.append(("rt", ri))
                cols.append(h_t)
                pids_order.append(("rz", ri))
                cols.append(z)
            del invs, inv_in, inv_t, range_data, t_lag, m_lag, h_lags, h, h_t
            del contrib, z
        for pid, col in zip(pids_order, cols):
            lag[pid] = col
        r_coeff = _l2c_chunked(dom, lag, pids_order, ext_chunk)
        r_comms = cm(
            [r_coeff[:, i] for i in range(r_coeff.shape[1])],
            [_blind(pid) for pid in pids_order],
        )
        for i, pid in enumerate(pids_order):
            coeff[pid] = r_coeff[:, i]
            tw.write_point(r_comms[i])
        del r_coeff, cols
    if asg.host:
        # a host-stored witness: the Lagrange columns made in phases 2-4
        # rest beside it until the multiopen folds them, leaving the card
        # to the coefficients and the quotient's blocks
        lag.rest()

    phases.end("grand products")
    y = tw.challenge()

    # 5. quotient
    q_coeff_full = quotient_coeff(
        cs, dom, coeff, (theta, beta, gamma, y), u, perm_cols, ext_chunk,
        gate_slab, on_folded=lambda _: phases.end("constraint ext eval"))
    n_ext = dom.n_ext
    n_chunks = n_ext // n
    q_whole = q_coeff_full.reshape(16, n_chunks, n)
    # the chunks' Lagrange columns, whole as every Lagrange column, from
    # the whole coefficients every rank holds (no collective)
    with span("ntt"):
        q_lag = dom.coeff_to_lagrange(q_whole)
    q_chunks = dom.block(q_whole)
    q_comms = cm(
        [q_chunks[:, c] for c in range(n_chunks)],
        [_blind(("q", c)) for c in range(n_chunks)],
    )
    for c in range(n_chunks):
        coeff[("q", c)] = q_chunks[:, c]
        lag[("q", c)] = q_lag[:, c]
        tw.write_point(q_comms[c])
    del q_coeff_full, q_whole, q_lag, q_chunks

    phases.end("quotient+commit")
    x = tw.challenge()

    # 6. evaluations: one batched evaluation per distinct point
    slots = eval_schedule(cs, len(perm_cols), n_chunks)
    evals: dict[tuple, int] = {}  # (pid, rot) -> value
    omega = dom.omega
    points = {
        0: x % P,
        1: x * omega % P,
        -1: x * pow(omega, P - 2, P) % P,
    }
    by_rot: dict[int, list] = {}
    for slot in slots:
        by_rot.setdefault(slot.rotation, []).append(slot)
    with span("open.evaluate"):
        for rot, group in by_rot.items():
            zd = FP.encode([points[rot]], device=dev)[:, 0]
            for lo in range(0, len(group), eval_slab):
                chunk = group[lo : lo + eval_slab]
                stack_c = torch.stack([coeff[s.pid] for s in chunk], dim=1)
                vals = FP.decode(eval_poly_rows(FP, stack_c, zd))
                del stack_c
                for s, val in zip(chunk, vals):
                    evals[(s.pid, s.rotation)] = val
    for slot in slots:
        if slot.opened:
            tw.write_scalar(evals[(slot.pid, slot.rotation)])

    phases.end("evaluations")
    # 7. multiopen (BDFG batch opening, one IPA); `coeff` and `lag` are
    # dropped once folded, so the opening's MSMs run beside the key alone
    multiopen_prove(srs, dom, tw, coeff, lag, slots, points, evals, blinds,
                    rng=rng, commit_chunk=commit_chunk, fold_slab=eval_slab,
                    on_folded=lambda: (coeff.clear(), lag.clear()))
    phases.end("multiopen+ipa")
    return tw.finalize()


def multiopen_prove(srs, dom, tw, coeff, lag, slots, points, evals,
                    blinds=None, rng=secrets, commit_chunk=COMMIT_CHUNK,
                    fold_slab=EVAL_SLAB, on_folded=None):
    """Phase 7: the BDFG batch opening and its one IPA.  `coeff` holds
    this rank's row blocks under a mesh context (`create_proof`), `lag`
    whole Lagrange columns: each point's P is folded on both (its
    coefficients a row block; `fold_slab` columns a stack), Q's
    coefficients are the row block of the
    whole Q on H, its commitment and the w values come from the blocks,
    and the opened T = Q + Σ s^j·P_j is gathered once for `open_poly`.
    `on_folded()` is called once every P is folded, the last read of
    `coeff` and `lag`."""
    blinds = blinds or {}
    dev = dom.device
    n = dom.n
    v = tw.challenge()
    u = tw.challenge()
    rot_order = multiopen_point_order(slots)

    def const(val: int) -> torch.Tensor:
        return FP.const(val, 1, dev)

    with span("open.fold"):
        omega_tbl = torch.as_tensor(dom.omega_powers(), device=dev)
        q_lag_total = None
        p_group = []  # (rot, P_lag, P_coeff, r_value, p_blind)
        for rot in rot_order:
            group = [s for s in slots if s.opened and s.rotation == rot]
            weights = []
            vi = 1
            r_val = 0
            for s in group:
                weights.append(vi)
                r_val = (r_val + vi * evals[(s.pid, rot)]) % P
                vi = vi * v % P
            p_lag = None
            p_coeff = None
            for lo in range(0, len(group), fold_slab):
                chunk = group[lo : lo + fold_slab]
                w_dev = FP.encode(weights[lo : lo + fold_slab],
                                  device=dev)[:, :, None]
                lag_stack = torch.stack([lag[s.pid] for s in chunk], dim=1)
                part_lag = tree_sum(FP, FP.mul(lag_stack, w_dev), axis=1)
                del lag_stack
                coeff_stack = torch.stack([coeff[s.pid] for s in chunk], dim=1)
                part_coeff = tree_sum(FP, FP.mul(coeff_stack, w_dev), axis=1)
                del coeff_stack
                p_lag = part_lag if p_lag is None else FP.add(p_lag, part_lag)
                p_coeff = (part_coeff if p_coeff is None
                           else FP.add(p_coeff, part_coeff))
            p_blind = sum(
                w * blinds.get(s.pid, 0) for w, s in zip(weights, group)
            ) % P
            p_group.append((rot, p_lag, p_coeff, r_val, p_blind))
        if on_folded is not None:
            on_folded()

        uj = 1
        for rot, p_lag, p_coeff, r_val, _ in p_group:
            z = points[rot]
            inv_denom = FP.inv(FP.sub(omega_tbl, const(z)))
            numer = FP.sub(p_lag, const(r_val).expand(16, n))
            term = FP.mul(FP.mul(const(uj), numer), inv_denom)
            q_lag_total = (term if q_lag_total is None
                           else FP.add(q_lag_total, term))
            uj = uj * u % P

    with span("ntt"):
        q_coeff = dom.lagrange_to_coeff_rows(dom.block(q_lag_total))
    q_blind = rng.randbelow(P)
    tw.write_point(commit(srs, q_coeff, blind=q_blind,
                          commit_chunk=commit_chunk))
    zstar = tw.challenge()
    zd = FP.encode([zstar], device=dev)[:, 0]

    w_vals = []
    with span("open.evaluate"):
        for rot, p_lag, p_coeff, r_val, _ in p_group:
            wv = FP.decode(eval_poly_rows(FP, p_coeff, zd)[:, None])[0]
            w_vals.append(wv)
            tw.write_scalar(wv)

    s_ch = tw.challenge()
    t_coeff = q_coeff
    t_blind = q_blind
    sj = s_ch
    with span("open.fold"):
        for (_, _, p_coeff, _, p_blind), wv in zip(p_group, w_vals):
            t_coeff = FP.add(t_coeff, FP.mul(const(sj), p_coeff))
            t_blind = (t_blind + sj * p_blind) % P
            sj = sj * s_ch % P

    # the one polynomial the IPA opens, gathered (the JAX `jnp.take` of the
    # fold, which GSPMD gathers)
    open_poly(srs, tw, dom.gather(t_coeff), zstar, blind=t_blind, rng=rng)
