"""Rank bodies for `run_on_mesh`: each runs one sharded path on this rank.

Inputs are replicated on every rank (numpy arrays and Python values, as
`run_on_mesh` pickles them); each body takes this rank's block, runs the
sharded function, and returns numpy arrays or host values.  The timed
paths return, beside their output, what `measured` saw on this rank: the
seconds (after the device finished), the kernel launch counts (reset at
the start of the path), the collectives' field elements this rank sent,
by kind (`shard/mesh.py`), and the peak device memory.  Used by
`entry.dryrun_multichip`, `shard.scaling`, the tests and `chip_smoke.py`.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import kernels
from ..curve.vesta import PointBatch, to_affine_host
from ..ipa.ipa import COMMIT_CHUNK, pass_widths
from ..ipa.srs import CACHE_DIR, setup
from ..utils.profiling import counters
from .context import mesh_context
from .mesh import Mesh
from .msm import msm_many_sharded, msm_sharded
from .ntt import _twiddle_block, ntt_sharded
from .rows import gate_eval_sharded, rolled


class SeededRng:
    """`randbelow(n)` from a seeded `random.Random`: the stream of the
    recorded JAX proofs (`scripts/torch_golden*.py`) and of
    `chip_smoke.py`."""

    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def moved(since: dict) -> dict:
    """{kind: field elements this rank sent} of each collective kind that
    moved since the snapshot `since` (`counters.snapshot("mesh.")`);
    "unsplit": the columns of transforms the mesh did not split."""
    out = {}
    for key, (ops, _) in counters.snapshot("mesh.").items():
        d = ops - since.get(key, (0, 0.0))[0]
        if d:
            out[key[len("mesh."):]] = d
    return out


def measured(mesh: Mesh, fn, *args):
    """(fn(*args), stats): launch counts reset before the call, seconds
    taken after the device finished, the collectives of the call
    (`moved`) and its peak device memory (0 on the CPU)."""
    _sync(mesh)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    kernels.reset_launch_counts()
    m0 = counters.snapshot("mesh.")
    t0 = time.time()
    out = fn(*args)
    _sync(mesh)
    return out, {"seconds": time.time() - t0,
                 "launches": kernels.launch_counts(),
                 "collectives": moved(m0),
                 "peak_bytes": torch.cuda.max_memory_allocated(mesh.device)
                 if cuda else 0}


def _tensor(mesh: Mesh, a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=mesh.device)


def exchange(mesh: Mesh, x_all: np.ndarray, split_axis: int,
             concat_axis: int) -> np.ndarray:
    """`Mesh.all_to_all` of rank r's input `x_all[r]`."""
    x = _tensor(mesh, x_all[mesh.rank])
    return mesh.all_to_all(x, split_axis, concat_axis).cpu().numpy()


def twiddles(mesh: Mesh, log_n: int, inverse: bool) -> np.ndarray:
    """This rank's (16, R, C/D) twiddle block of the sharded NTT."""
    return _twiddle_block(mesh, log_n, inverse).cpu().numpy()


def ntt_path(mesh: Mesh, a: np.ndarray, inverse: bool = False):
    """(the gathered `ntt_sharded` of the (16, ..., n) limbs `a`, stats)."""
    a_t = _tensor(mesh, a)
    out, stats = measured(mesh, lambda: mesh.all_gather(
        ntt_sharded(mesh, mesh.block(a_t), inverse), -1))
    return out.cpu().numpy(), stats


def msm_path(mesh: Mesh, scalars: np.ndarray, points: np.ndarray | None = None,
             k: int | None = None, cache_dir: str | None = CACHE_DIR):
    """(the affine sums, stats) of the sharded MSM of plain scalar limbs
    (16, N) (`msm_sharded`: one sum) or (16, B, N) (`msm_many_sharded`: B
    sums) against `points` ((3, 16, N) limbs of an affine-or-identity
    PointBatch) or, when None, the 2^k generators of `setup(k, cache_dir)`
    (loaded before the timed call)."""
    sc = _tensor(mesh, scalars)
    if points is None:
        pts = setup(k, mesh.device, cache_dir=cache_dir).g
    else:
        pts = PointBatch(*(_tensor(mesh, c) for c in points))
    blk = PointBatch(*(mesh.block(c) for c in pts))
    fn = msm_many_sharded if sc.dim() == 3 else msm_sharded
    out, stats = measured(mesh, fn, mesh, mesh.block(sc), blk)
    if sc.dim() == 2:
        out = PointBatch(*(c[:, None] for c in out))
    return to_affine_host(out), stats


def roll_path(mesh: Mesh, x: np.ndarray, shift: int) -> np.ndarray:
    """The gathered `rolled` blocks of the column `x`: roll(x, -shift)."""
    out = rolled(mesh, mesh.block(_tensor(mesh, x)), shift)
    return mesh.all_gather(out, -1).cpu().numpy()


def gate_path(mesh: Mesh, x: np.ndarray) -> np.ndarray:
    """The gathered row-sharded gate x·(next(x) + x) of the column `x`."""
    out = gate_eval_sharded(mesh, mesh.block(_tensor(mesh, x)))
    return mesh.all_gather(out, -1).cpu().numpy()


def toy_proof(mesh: Mesh, seed: int | None = None) -> dict:
    """The k = 6 toy circuit (`plonk/toy.py`) proved by
    `create_proof(mesh=)`, under `SeededRng(seed)` (`secrets` when None).
    Rank 0 runs the single-device `verify_proof` on it, the last rank
    checks that a changed public input is rejected (rank 0 does both on
    one rank).  Returns the proof bytes, the checks and the stats (with
    the prover's phases as `config_proof` gives them)."""
    import secrets

    from ..plonk import create_proof, keygen, verify_proof
    from ..plonk.toy import K, P, toy_circuit

    toy = toy_circuit()
    srs = setup(K, mesh.device)
    pk = keygen(srs, toy.cs, toy.fixed_assignment(mesh.device))
    asg = toy.assignment(device=mesh.device)
    rng = secrets if seed is None else SeededRng(seed)
    proof, stats = _proof_measured(mesh, lambda hook: create_proof(
        srs, pk, asg, rng=rng, mesh=mesh, phase_hook=hook))
    good = toy.public_values(toy.witness_values())
    bad = [(good[0] + 1) % P] + good[1:]
    out = {"proof": proof, "stats": stats, "verified": None, "rejected": None}
    if mesh.rank == 0:
        out["verified"] = verify_proof(srs, pk.vk, [good], proof)
    if mesh.rank == mesh.size - 1:
        out["rejected"] = not verify_proof(srs, pk.vk, [bad], proof)
    return out


def config_proof(mesh: Mesh, config: int = 2, seed: int = 0,
                 cache_dir: str | None = CACHE_DIR,
                 log_phases: bool = False) -> dict:
    """BASELINE config `config` (its program, steps and k, W = 24) proved
    by `create_proof(mesh=)` under `SeededRng(seed)`, the SRS from
    `cache_dir` and the key from there when `prove_config` has cached it
    (else `keygen`).  Rank 0 verifies the proof, the last rank checks that
    answer + 1 is rejected.  Returns the proof bytes, the checks and the
    stats, with the seconds of the prover's seven phases on this rank, the
    collectives of each ("phase_collectives") and the peak device memory
    so far at the end of each ("phase_peak_gib").  `log_phases` prints
    each phase as this rank ends it."""
    import os

    from ..plonk import create_proof, load_pk
    from ..tinyram.circuit import TinyRamCircuit
    from ..tinyram.emulator import eval_program
    from ..tinyram.prove_config import CONFIGS, REG_COUNT, WORD_BITS, key_path

    program, steps_log2, k = CONFIGS[config]
    prog = program(1 << steps_log2, word_bits=WORD_BITS)
    trace = eval_program(prog, WORD_BITS, REG_COUNT)
    circ = TinyRamCircuit(WORD_BITS, REG_COUNT, k=k)
    srs = setup(circ.k, mesh.device, cache_dir=cache_dir)
    path = None if cache_dir is None else key_path(cache_dir, config,
                                                   WORD_BITS, circ.k)
    pk = load_pk(path, circ.tcs.cs, mesh.device) \
        if path is not None and os.path.exists(path) else circ.keygen(srs)
    asg = circ.assignment(trace, mesh.device)
    proof, stats = _proof_measured(mesh, lambda hook: create_proof(
        srs, pk, asg, rng=SeededRng(seed), mesh=mesh, phase_hook=hook),
        log_phases)
    out = {"proof": proof, "stats": stats, "verified": None, "rejected": None,
           "k": circ.k}
    if mesh.rank == 0:
        out["verified"] = circ.verify(srs, pk, prog, trace.answer, proof)
    if mesh.rank == mesh.size - 1:
        out["rejected"] = not circ.verify(srs, pk, prog, trace.answer + 1,
                                          proof)
    return out


def _proof_measured(mesh: Mesh, prove, log_phases: bool = False):
    """`measured` of `prove(phase_hook)` with the prover's counters
    cleared first, and in its stats, per prover phase: its seconds
    ("phases"), its collectives ("phase_collectives") and the peak device
    memory at its end ("phase_peak_gib", 0 on the CPU)."""
    counters.ops.clear()
    counters.seconds.clear()
    peaks = {}

    def hook(name, seconds, launches):
        peaks[name] = (torch.cuda.max_memory_allocated(mesh.device) / 2**30
                       if mesh.device.type == "cuda" else 0.0)
        if log_phases:
            print(f"[rank {mesh.rank}] {name}: {seconds:.3f}s, {launches} "
                  f"launches, peak so far {peaks[name]:.3f} GiB", flush=True)

    proof, stats = measured(mesh, lambda: prove(hook))
    rep = counters.report()
    stats["phases"] = {name[len("prover."):]: v["seconds"]
                       for name, v in rep.items()
                       if name.startswith("prover.") and "/" not in name}
    stats["phase_collectives"] = _phase_collectives(rep)
    stats["phase_peak_gib"] = peaks
    return proof, stats


def gather_pattern(cs, k: int, D: int, commit_chunk: int = COMMIT_CHUNK
                   ) -> dict:
    """{prover phase: the field elements a rank sends by `all_gather` in
    it} of `create_proof(mesh=)` of the constraint system `cs` at 2^k rows
    on D ranks that split every transform, reckoned from `cs` alone:
      * every commitment: three coordinates of each MSM column's partial
        sum (padded columns included) to D − 1 ranks;
      * "quotient+commit": the quotient's coefficients, (D − 1)·n_ext/D
        (its chunks' Lagrange form is taken from them on every rank);
      * "evaluations": one field element a slot (the sum of the partials);
      * "multiopen+ipa": Q's commitment, a partial a point, the opened
        polynomial (D − 1)·n/D, and the IPA's pair of MSMs a round.
    The coefficient stacks themselves are never gathered: "commit
    instance+advice", "lookup permute+commit" and "grand products" carry
    only MSM partials, "constraint ext eval" nothing.  The instance and
    advice transforms run before the first phase's clock (as the JAX
    prover's), so the whole proof's all-gather is the sum of these."""
    from ..plonk.protocol import eval_schedule, multiopen_point_order

    n = 1 << k
    n_chunks = 1 << cs.extension_factor_log2()
    n_sigma = len(cs.permutation_columns())
    n_lk, rls = len(cs.lookups), cs.range_lookups

    def msm(*cols):
        return 3 * (D - 1) * sum(sum(pass_widths(c, commit_chunk))
                                 for c in cols)

    slots = eval_schedule(cs, n_sigma, n_chunks)
    return {
        "commit instance+advice": msm(cs.num_instance + cs.num_advice),
        "lookup permute+commit": msm(2 * n_lk, len(rls)),
        "grand products": msm(1 if n_sigma else 0, n_lk,
                              sum(len(rl.batches()) + 2 for rl in rls)),
        "constraint ext eval": 0,
        "quotient+commit": (D - 1) * (n_chunks * n // D) + msm(n_chunks),
        "evaluations": (D - 1) * len(slots),
        "multiopen+ipa": msm(1) + (D - 1) * (
            len(multiopen_point_order(slots)) + n // D + 6 * k),
    }


def gathered_by_phase(stats: dict) -> dict:
    """{phase: all-gather elements this rank sent in it} of the seven
    prover phases, from a proof's stats (`config_proof`, `toy_proof`)."""
    coll = stats["phase_collectives"]
    return {ph: coll.get(ph, {}).get("all_gather", {}).get("elements", 0)
            for ph in stats["phases"]}


def _phase_collectives(rep: dict) -> dict:
    """{phase: {kind: {"elements", "seconds"}}} of a prover's
    "prover.<phase>/<kind>" counters (`counters.report()`)."""
    out: dict = {}
    for name, v in rep.items():
        if name.startswith("prover.") and "/" in name:
            phase, kind = name[len("prover."):].split("/")
            out.setdefault(phase, {})[kind] = {"elements": v["ops"],
                                               "seconds": v["seconds"]}
    return out


def rows_transform_path(mesh: Mesh, lag: np.ndarray, k: int) -> dict:
    """`Domain(Fp, k, k)`'s `lagrange_to_coeff_rows` of this rank's block
    of the Lagrange columns `lag` (16, ..., 2^k), then
    `coeff_to_lagrange_rows` of that block: both blocks and the
    collectives of each."""
    from ..field.field import FP
    from ..poly.domain import Domain

    dom = Domain(FP, k, k, mesh.device)
    a = mesh.block(_tensor(mesh, lag))
    with mesh_context(mesh):
        coeff, fwd = measured(mesh, dom.lagrange_to_coeff_rows, a)
        back, inv = measured(mesh, dom.coeff_to_lagrange_rows, coeff)
    return {"coeff": coeff.cpu().numpy(), "back": back.cpu().numpy(),
            "l2c": fwd["collectives"], "c2l": inv["collectives"]}


def extended_rows_path(mesh: Mesh, coeffs: np.ndarray, k: int,
                       extended_k: int) -> dict:
    """`Domain(Fp, k, extended_k)`'s `coeff_to_extended_rows` of this
    rank's row block of the coefficients `coeffs` (16, ..., 2^k) under the
    mesh, then `extended_rows_to_coeff` of that block: this rank's block,
    the whole coefficients back, and the collectives of each."""
    from ..field.field import FP
    from ..poly.domain import Domain

    dom = Domain(FP, k, extended_k, mesh.device)
    a = mesh.block(_tensor(mesh, coeffs))
    with mesh_context(mesh):
        block, lift = measured(mesh, dom.coeff_to_extended_rows, a)
        back, inv = measured(mesh, dom.extended_rows_to_coeff, block)
    return {"block": block.cpu().numpy(), "back": back.cpu().numpy(),
            "lift": lift["collectives"], "inverse": inv["collectives"]}


def commit_rows_path(mesh: Mesh, coeffs: np.ndarray, k: int,
                     blinds: list, commit_chunk: int) -> dict:
    """`commit_many` of this rank's row blocks of the B coefficient
    vectors `coeffs` (16, B, 2^k) against `setup(k)` (hashed here, not
    cached) under the mesh: the affine commitments and the collectives."""
    from ..ipa.ipa import commit_many

    srs = setup(k, mesh.device, cache_dir=None)
    blk = mesh.block(_tensor(mesh, coeffs))
    with mesh_context(mesh):
        comms, stats = measured(mesh, lambda: commit_many(
            srs, [blk[:, i] for i in range(blk.shape[1])], blinds=blinds,
            commit_chunk=commit_chunk))
    return {"commitments": comms, "collectives": stats["collectives"]}


def eval_rows_path(mesh: Mesh, coeffs: np.ndarray, x: np.ndarray) -> dict:
    """`eval_poly_rows` of this rank's row block of the coefficients
    `coeffs` (16, ..., n) at the Montgomery scalar `x` (16,) under the
    mesh: the values (16, ...) and the collectives."""
    from ..field.field import FP
    from ..poly.ntt import eval_poly_rows

    blk = mesh.block(_tensor(mesh, coeffs))
    with mesh_context(mesh):
        vals, stats = measured(mesh, eval_poly_rows, FP, blk,
                               _tensor(mesh, x))
    return {"values": vals.cpu().numpy(), "collectives": stats["collectives"]}


def quotient_path(mesh: Mesh, cs, k: int, coeffs: dict, challenges: tuple,
                  u: int, ext_chunk: int, gate_slab: int) -> dict:
    """`plonk.prover.quotient_coeff` of the constraint system `cs` on a
    `Domain(Fp, k, k + cs.extension_factor_log2())`, fed with this rank's
    row block of the coefficient columns `coeffs` (pid -> (16, 2^k) limbs,
    whole on every rank) under the mesh, as `create_proof` feeds it: the
    quotient's coefficients, the collectives of the fold and of what
    follows it, and the row counts of every lifted block and of the folded
    one."""
    from ..field.field import FP
    from ..plonk.prover import quotient_coeff
    from ..poly.domain import Domain

    dom = Domain(FP, k, k + cs.extension_factor_log2(), mesh.device)
    coeff = {pid: mesh.block(_tensor(mesh, c)) for pid, c in coeffs.items()}
    seen = {"lifted": set()}
    lift = dom.coeff_to_extended_rows

    def lift_seen(a):
        out = lift(a)
        seen["lifted"].add(out.shape[-1])
        return out

    dom.coeff_to_extended_rows = lift_seen
    with mesh_context(mesh):
        m0 = counters.snapshot("mesh.")

        def on_folded(acc):
            seen["fold"] = moved(m0)
            seen["folded"] = acc.shape[-1]
            seen["m1"] = counters.snapshot("mesh.")

        q = quotient_coeff(cs, dom, coeff, challenges, u,
                           cs.permutation_columns(), ext_chunk, gate_slab,
                           on_folded=on_folded)
    return {"q": q.cpu().numpy(), "fold": seen["fold"],
            "after": moved(seen["m1"]), "lifted": sorted(seen["lifted"]),
            "folded": seen["folded"]}


def raise_on_rank(mesh: Mesh, rank: int) -> None:
    """Rank `rank` raises; the others wait for it in a barrier, which it
    never reaches (the launcher's check of a failing rank)."""
    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    mesh.barrier()


def sequence(mesh: Mesh, calls: list) -> list:
    """[fn(mesh, *args) for (fn, args) in calls]: several paths in one
    start of the ranks."""
    return [fn(mesh, *args) for fn, args in calls]
