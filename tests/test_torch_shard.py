"""The port's `shard/` on gloo ranks of the CPU against the JAX package.

Each mesh test starts D = 2 or 4 ranks (`run_on_mesh`, one spawned process
each, a deadline of its own) once per D and runs every sharded path there
(`shard.paths.sequence`); the tests then hold the ranks' results against:
  * a numpy model of the tiled all-to-all, for each (split, concat) pair
    the four-step NTT uses;
  * the JAX `ntt_sharded` on the conftest's virtual mesh (`make_mesh(D)`)
    and its `_twiddle_matrix`, and the port's single-device `ntt`, bit for
    bit; the inverse round trip;
  * the JAX package's `curve/host.py` `msm` in affine form, for
    `msm_sharded` and `msm_many_sharded` over 8·D points;
  * the unsharded gate x·(next(x) + x) and `np.roll`, for the halo
    exchange (rotations forward, backward and by a whole block, on one
    column and on a (16, B, m) stack);
  * the single-device `Domain` for the row-block transforms, each fed
    with the rank's row block: `lagrange_to_coeff_rows` is the rank's
    block of `lagrange_to_coeff` and `coeff_to_lagrange_rows` takes it
    back, at a size the mesh splits and at one it does not;
    `coeff_to_extended_rows` is the rank's block of `coeff_to_extended`
    (split, unsplit, padded to n_ext = 4n with the pad folded into the
    first all-to-all, and blocks shorter than a row, lifted whole as an
    unsplit lift), and `extended_rows_to_coeff` gives the whole
    coefficients back;
  * `commit_many` of row blocks against the single-device `commit_many`
    and the JAX package's host `msm` (affine, blinds and a padded second
    pass included), and
    `eval_poly_rows` of row blocks against `eval_poly` and the JAX
    `eval_poly`, each with its collectives (the MSM partials; one sum);
  * the single-device `quotient_coeff` of a constraint system built here
    (a gate with rotations -1, 0, +1, a plookup, a LogUp range lookup of
    two batches, a copy constraint; random coefficient columns at k = 5),
    fed with row blocks, with the collectives of its fold (no gather,
    every extended block n_ext/D rows) and of its end (the quotient's
    coefficients, gathered).
Inputs come from `np.random.default_rng(seed)`; tolerance 0 everywhere.
The launcher must raise within its deadline when a rank raises or runs
past it.
"""

import functools
import importlib
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinyram_tpu.curve import host as jhost
from tinyram_tpu.field import FP as JFP
from tinyram_tpu.shard import make_mesh as jmake_mesh
from tinyram_tpu.shard import ntt_sharded as jntt_sharded
from tinyram_tpu.shard.ntt import _twiddle_matrix
from tinyram_tpu_torch.curve.vesta import from_affine_host
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.ipa.ipa import commit_many
from tinyram_tpu_torch.ipa.srs import _hash_to_curve, setup
from tinyram_tpu_torch.plonk.circuit import ConstraintSystem
from tinyram_tpu_torch.plonk.prover import quotient_coeff
from tinyram_tpu_torch.poly.domain import Domain
from tinyram_tpu_torch.poly.ntt import eval_poly, ntt
from tinyram_tpu_torch.shard import (Mesh, RankError, backend_for,
                                     rank_devices, run_on_mesh)
from tinyram_tpu_torch.shard import paths
from tinyram_tpu_torch.shard.ntt import _split_rc
from tinyram_tpu_torch.shard.rows import gate_eval, rolled

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

jntt = importlib.import_module("tinyram_tpu.poly.ntt")  # the package exports ntt()

DEADLINE_S = 300.0  # every mesh run here ends well inside it
LOG_NS = (6, 8)
# (local shape, split axis, concat axis): the three exchanges of the
# four-step NTT on a (16, n/D) block and on a (16, B, n/D) batch
A2A_CASES = [((16, 4, 8), 2, 1), ((16, 8, 4), 1, 2), ((16, 3, 4, 8), 3, 2),
             ((16, 3, 8, 4), 2, 3)]
B = 3  # msm_many columns
SHIFTS = (-3, -1, 2, 32)  # rotations of the halo exchange (32: a whole block)
STACK_SHIFTS = (-4, 4)  # on a (16, 3, m) stack: rotation ±1 at scale 4
Q_K = 5  # the quotient's constraint system: n = 32, n_ext = 128
Q_EXT_CHUNK, Q_GATE_SLAB = 3, 2  # several lifts and gate slabs at this size
ROWS_CASES = ("split", "unsplit", "padded", "short")
COMMIT_COLS, COMMIT_CHUNK = 5, 4  # two MSM passes, the second padded to 4
COMMIT_BLINDS = [0, 7, 0, 1 << 200, 3]
EVAL_LOG = 7


def _limbs(rng, shape):
    limbs = rng.integers(0, 1 << 16, size=(16,) + tuple(shape), dtype=np.int64)
    limbs[15] &= 0x3FFF  # canonical: below 2^254 < p
    return limbs.astype(np.int32)


def _points(rng, n):
    """n affine points k·G (one of them the identity) for random k."""
    base = _hash_to_curve(b"shard-test", 0)
    pts = [jhost.scalar_mul(int(k), base)
           for k in rng.integers(1, 1 << 62, size=n)]
    pts[n // 2] = None
    return pts


def _ints(limbs):
    """Plain ints of (16, ...) limbs, last axis innermost."""
    flat = np.asarray(limbs, dtype=np.int64).reshape(16, -1)
    return [sum(int(flat[i, j]) << (16 * i) for i in range(16))
            for j in range(flat.shape[1])]


def _quotient_cs():
    """One of each constraint family of the quotient phase: a gate with
    rotations -1, 0, +1 (and an instance column), a plookup, a LogUp range
    lookup of five inputs (two batches), a copy constraint."""
    cs = ConstraintSystem()
    q, t = cs.fixed_column("q"), cs.fixed_column("t")
    a, b, c = (cs.advice_column(name) for name in "abc")
    pub = cs.instance_column("pub")
    cs.blinding_factors = 3
    cs.gate("rot", [q.cur() * (a.next() - a.cur() - b.prev()),
                    q.cur() * (c.cur() - pub.cur())])
    cs.gate("next", q.cur() * c.next() * b.cur())
    cs.lookup("lk", [q.cur() * a.cur()], [t.cur()])
    cs.range_lookup("rl", [a.cur(), b.cur(), c.cur(), a.cur() + b.cur(),
                           b.cur() - c.cur()], t.cur())
    cs.copy(a, 0, c, 1)
    return cs


def _quotient_pids(cs):
    """The coefficient columns `quotient_coeff` reads."""
    pids = [("fixed", i) for i in range(cs.num_fixed)]
    pids += [("advice", i) for i in range(cs.num_advice)]
    pids += [("instance", i) for i in range(cs.num_instance)]
    pids += [("sigma", j) for j in range(len(cs.permutation_columns()))]
    pids += [("zperm",)]
    for li in range(len(cs.lookups)):
        pids += [("la", li), ("ls", li), ("lz", li)]
    for ri, rl in enumerate(cs.range_lookups):
        pids += [("rm", ri), ("rt", ri), ("rz", ri)]
        pids += [("rh", ri, b) for b in range(len(rl.batches()))]
    return pids


@functools.lru_cache(maxsize=None)
def _quotient_inputs():
    """(the constraint system, its coefficient columns, (θ, β, γ, y)), the
    same at every D."""
    rng = np.random.default_rng(99)
    cs = _quotient_cs()
    cols = {pid: _limbs(rng, (1 << Q_K,)) for pid in _quotient_pids(cs)}
    return cs, cols, tuple(int(v) for v in rng.integers(1, 1 << 62, size=4))


@functools.lru_cache(maxsize=None)
def _quotient_want():
    """The single-device `quotient_coeff` of `_quotient_inputs()`."""
    cs, cols, ch = _quotient_inputs()
    dom = Domain(FP, Q_K, Q_K + cs.extension_factor_log2(), "cpu")
    assert dom.n_ext == 4 * dom.n
    return quotient_coeff(
        cs, dom, {pid: torch.as_tensor(c) for pid, c in cols.items()}, ch,
        cs.usable_rows(dom.n), cs.permutation_columns(), Q_EXT_CHUNK,
        Q_GATE_SLAB).numpy()


def _rows_case(D, case):
    """(k, extended k) of the row-block transforms: "split", (7, 7), splits
    at D = 2 and 4; "unsplit", (1, 1) at D = 2 and (3, 3) at D = 4, leaves
    C = 1 or 2 (`_split_rc`) not divisible by D; "padded", (5, 7), lifts
    blocks of whole rows of the (16, 8) split into n_ext = 4n, the zero
    pad folded into the first all-to-all; "short", (3, 7), has blocks of
    4 or 2 coefficients, shorter than a row of 8, which are gathered and
    lifted whole, as an unsplit lift."""
    return {"split": (7, 7), "padded": (5, 7), "short": (3, 7),
            "unsplit": (1, 1) if D == 2 else (3, 3)}[case]


def _inputs(D):
    rng = np.random.default_rng(100 + D)
    a2a = [rng.integers(0, 1 << 16, size=(D,) + shape).astype(np.int32)
           for shape, _, _ in A2A_CASES]
    cols = {log_n: _limbs(rng, (1 << log_n,)) for log_n in LOG_NS}
    batch = _limbs(rng, (2, 1 << LOG_NS[0]))
    pts = _points(rng, 8 * D)
    pb = np.stack([c.numpy() for c in from_affine_host(pts)])
    sc = _limbs(rng, (8 * D,))
    sc[:, 1] = 0  # one zero scalar
    sc_many = _limbs(rng, (B, 8 * D))
    gate = _limbs(rng, (32 * D,))
    stack = _limbs(rng, (3, 32 * D))
    rows = {case: _limbs(rng, (2, 1 << _rows_case(D, case)[0]))
            for case in ROWS_CASES}
    commit = _limbs(rng, (COMMIT_COLS, 1 << Q_K))
    ev = _limbs(rng, (3, 1 << EVAL_LOG))
    x = _limbs(rng, ())
    cs, q_cols, q_ch = _quotient_inputs()
    return dict(a2a=a2a, cols=cols, batch=batch, pts=pts, pb=pb, sc=sc,
                sc_many=sc_many, gate=gate, stack=stack, rows=rows,
                commit=commit, ev=ev, x=x, cs=cs, q_cols=q_cols, q_ch=q_ch)


def _calls(inp):
    calls = [(paths.exchange, (x, s, c))
             for x, (_, s, c) in zip(inp["a2a"], A2A_CASES)]
    for log_n, a in inp["cols"].items():
        calls += [(paths.ntt_path, (a, False)), (paths.ntt_path, (a, True)),
                  (paths.twiddles, (log_n, False)),
                  (paths.twiddles, (log_n, True))]
    calls += [(paths.ntt_path, (inp["batch"], False)),
              (paths.msm_path, (inp["sc"], inp["pb"])),
              (paths.msm_path, (inp["sc_many"], inp["pb"])),
              (paths.gate_path, (inp["gate"],))]
    calls += [(paths.roll_path, (inp["gate"], s)) for s in SHIFTS]
    calls += [(paths.roll_path, (inp["stack"], s)) for s in STACK_SHIFTS]
    D = inp["stack"].shape[-1] // 32
    calls += [(paths.extended_rows_path, (inp["rows"][case],)
               + _rows_case(D, case)) for case in ROWS_CASES]
    calls += [(paths.rows_transform_path, (inp["rows"][case],
                                           _rows_case(D, case)[0]))
              for case in ("split", "unsplit")]
    calls += [(paths.commit_rows_path, (inp["commit"], Q_K, COMMIT_BLINDS,
                                        COMMIT_CHUNK)),
              (paths.eval_rows_path, (inp["ev"], inp["x"]))]
    cs = inp["cs"]
    calls += [(paths.quotient_path, (cs, Q_K, inp["q_cols"], inp["q_ch"],
                                     cs.usable_rows(1 << Q_K), Q_EXT_CHUNK,
                                     Q_GATE_SLAB))]
    return calls


@pytest.fixture(scope="module", params=[2, 4], ids=lambda d: f"D{d}")
def mesh_run(request):
    """(D, inputs, {name: [rank results]}) of one start of D ranks."""
    D = request.param
    inp = _inputs(D)
    ranks = run_on_mesh(paths.sequence, D, _calls(inp), device="cpu",
                        timeout_s=DEADLINE_S)
    names = [f"a2a{i}" for i in range(len(A2A_CASES))]
    for log_n in LOG_NS:
        names += [f"ntt{log_n}", f"intt{log_n}", f"tw{log_n}", f"itw{log_n}"]
    names += ["ntt_batch", "msm", "msm_many", "gate"]
    names += [f"roll{s}" for s in SHIFTS]
    names += [f"stack_roll{s}" for s in STACK_SHIFTS]
    names += [f"rows_{case}" for case in ROWS_CASES]
    names += ["l2c_split", "l2c_unsplit", "commit", "eval", "quotient"]
    assert len(names) == len(ranks[0])
    return D, inp, {name: [r[i] for r in ranks] for i, name in enumerate(names)}


def _a2a_model(xs, split, concat):
    """Tiled all-to-all: rank j gets chunk j of every rank's split axis,
    joined along the concat axis in rank order."""
    D = len(xs)
    chunks = [np.split(x, D, axis=split) for x in xs]
    return [np.concatenate([chunks[i][j] for i in range(D)], axis=concat)
            for j in range(D)]


@pytest.mark.parametrize("case", range(len(A2A_CASES)))
def test_all_to_all_matches_numpy_model(mesh_run, case):
    D, inp, res = mesh_run
    _, split, concat = A2A_CASES[case]
    want = _a2a_model(list(inp["a2a"][case]), split, concat)
    got = res[f"a2a{case}"]
    assert len(got) == D
    for r in range(D):
        np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("log_n", LOG_NS)
def test_ntt_sharded_matches_jax_and_single_device(mesh_run, log_n):
    D, inp, res = mesh_run
    a = inp["cols"][log_n]
    want_jax = np.asarray(jntt_sharded(
        jmake_mesh(D), jnp.asarray(a.astype(np.uint32)))).astype(np.int64)
    want = ntt(FP, torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), want_jax)
    for out, stats in res[f"ntt{log_n}"]:
        np.testing.assert_array_equal(out, want)
        assert stats["seconds"] > 0 and stats["peak_bytes"] == 0


@pytest.mark.parametrize("log_n", LOG_NS)
def test_intt_sharded_roundtrip(mesh_run, log_n):
    _, inp, res = mesh_run
    a = inp["cols"][log_n]
    want = ntt(FP, torch.as_tensor(a), inverse=True).numpy()
    for out, _ in res[f"intt{log_n}"]:
        np.testing.assert_array_equal(out, want)
    back = ntt(FP, torch.as_tensor(res[f"intt{log_n}"][0][0])).numpy()
    np.testing.assert_array_equal(back, a)


@pytest.mark.parametrize("log_n", LOG_NS)
def test_twiddle_blocks_match_jax_table(mesh_run, log_n):
    """Each rank's device-built block equals its columns of the JAX
    package's host-built (16, R, C) table, both directions."""
    D, _, res = mesh_run
    _, C = _split_rc(log_n)
    for name, inverse in ((f"tw{log_n}", False), (f"itw{log_n}", True)):
        table = _twiddle_matrix("Fp", log_n, inverse).astype(np.int64)
        for r, blk in enumerate(res[name]):
            want = table[:, :, r * C // D:(r + 1) * C // D]
            np.testing.assert_array_equal(blk.astype(np.int64), want)


def test_ntt_sharded_batch_axis(mesh_run):
    """A (16, 2, n) batch: leading axes replicated, the last sharded."""
    _, inp, res = mesh_run
    want = ntt(FP, torch.as_tensor(inp["batch"])).numpy()
    for out, _ in res["ntt_batch"]:
        np.testing.assert_array_equal(out, want)


def test_msm_sharded_matches_host_oracle(mesh_run):
    D, inp, res = mesh_run
    want = jhost.msm(_ints(inp["sc"]), inp["pts"])
    assert want is not None
    for got, stats in res["msm"]:
        assert got == [want]
        assert stats["launches"]["B5l"] == 0  # the CPU runs plain versions


def test_msm_many_sharded_matches_host_oracle(mesh_run):
    _, inp, res = mesh_run
    sc = inp["sc_many"]
    want = [jhost.msm(_ints(sc[:, b]), inp["pts"]) for b in range(B)]
    for got, _ in res["msm_many"]:
        assert got == want


def test_gate_eval_halo_matches_unsharded(mesh_run):
    _, inp, res = mesh_run
    x = torch.as_tensor(inp["gate"])
    want = gate_eval(x).numpy()
    np.testing.assert_array_equal(
        want, FP.mul(x, FP.add(torch.roll(x, -1, -1), x)).numpy())
    for got in res["gate"]:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", SHIFTS)
def test_rolled_blocks_match_roll(mesh_run, shift):
    _, inp, res = mesh_run
    want = np.roll(inp["gate"], -shift, axis=-1)
    for got in res[f"roll{shift}"]:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", STACK_SHIFTS)
def test_rolled_stacks_match_roll(mesh_run, shift):
    """A (16, 3, m) stack of blocks, as the quotient phase rolls them."""
    _, inp, res = mesh_run
    want = np.roll(inp["stack"], -shift, axis=-1)
    for got in res[f"stack_roll{shift}"]:
        np.testing.assert_array_equal(got, want)


def test_rolled_raises_past_a_block():
    """A shift longer than the block raises before any collective."""
    mesh = Mesh(group=None, size=2, rank=0, device=torch.device("cpu"),
                backend="gloo")
    x = torch.zeros((16, 2, 4), dtype=torch.int32)
    for shift in (5, -5):
        with pytest.raises(ValueError, match="past a block of 4 rows"):
            rolled(mesh, x, shift)


@pytest.mark.parametrize("case", ROWS_CASES)
def test_coeff_to_extended_rows_is_the_ranks_block(mesh_run, case):
    """Each rank's block of the single-device coset evaluations, n_ext/D
    rows of each column, from the rank's n/D coefficients.  A split lift
    moves only all-to-alls: three of (D-1)/D of n_ext/D a column, or, with
    the pad folded in, the first of (D-1)/D of n/D.  An unsplit lift, and
    one of blocks shorter than a row, is counted (its two columns) and
    gathers the coefficients."""
    D, inp, res = mesh_run
    k, ext_k = _rows_case(D, case)
    a = inp["rows"][case]
    whole = Domain(FP, k, ext_k, "cpu").coeff_to_extended(
        torch.as_tensor(a)).numpy()
    n, m = 1 << k, (1 << ext_k) // D
    gathered = 2 * (n // D) * (D - 1)
    want = {"split": {"all_to_all": 2 * 3 * (D - 1) * m // D},
            "padded": {"all_to_all": 2 * (D - 1) * (n // D + 2 * m) // D},
            "short": {"unsplit": 2, "all_gather": gathered},
            "unsplit": {"unsplit": 2, "all_gather": gathered}}[case]
    for r, got in enumerate(res[f"rows_{case}"]):
        assert got["block"].shape == (16, 2, m)
        np.testing.assert_array_equal(got["block"],
                                      whole[..., r * m:(r + 1) * m])
        assert got["lift"] == want


@pytest.mark.parametrize("case", ROWS_CASES)
def test_extended_rows_to_coeff_gathers_the_coefficients(mesh_run, case):
    """The blocks give the whole coefficients (zero-padded to n_ext) back
    on every rank, with one gather of (D-1)/D of each column."""
    D, inp, res = mesh_run
    k, ext_k = _rows_case(D, case)
    a = inp["rows"][case]
    n_ext = 1 << ext_k
    want = np.zeros((16, 2, n_ext), dtype=np.int32)
    want[..., :a.shape[-1]] = a
    dom = Domain(FP, k, ext_k, "cpu")
    np.testing.assert_array_equal(
        dom.extended_to_coeff(dom.coeff_to_extended(torch.as_tensor(a))),
        want)
    for got in res[f"rows_{case}"]:
        np.testing.assert_array_equal(got["back"], want)
        assert got["inverse"]["all_gather"] == 2 * n_ext // D * (D - 1)


@pytest.mark.parametrize("split", [True, False], ids=["split", "unsplit"])
def test_lagrange_to_coeff_rows_is_the_ranks_block(mesh_run, split):
    """From the rank's block of two Lagrange columns, the rank's block of
    the single-device coefficients, and `coeff_to_lagrange_rows` takes it
    back to the rank's block of the columns.  A split mesh moves only
    all-to-alls; an unsplit one gathers the block (counted)."""
    D, inp, res = mesh_run
    case = "split" if split else "unsplit"
    k = _rows_case(D, case)[0]
    a = inp["rows"][case]
    whole = Domain(FP, k, k, "cpu").lagrange_to_coeff(
        torch.as_tensor(a)).numpy()
    m = (1 << k) // D
    for r, got in enumerate(res[f"l2c_{case}"]):
        np.testing.assert_array_equal(got["coeff"],
                                      whole[..., r * m:(r + 1) * m])
        np.testing.assert_array_equal(got["back"],
                                      a[..., r * m:(r + 1) * m])
        for kind in ("l2c", "c2l"):
            if split:
                assert set(got[kind]) == {"all_to_all"}
            else:
                assert got[kind] == {"unsplit": 2,
                                     "all_gather": 2 * m * (D - 1)}


@functools.lru_cache(maxsize=None)
def _commit_want(coeffs_bytes):
    coeffs = np.frombuffer(coeffs_bytes, dtype=np.int32).reshape(
        16, COMMIT_COLS, 1 << Q_K).copy()
    srs = setup(Q_K, "cpu", cache_dir=None)
    t = torch.as_tensor(coeffs)
    return commit_many(srs, [t[:, i] for i in range(COMMIT_COLS)],
                       blinds=COMMIT_BLINDS, commit_chunk=COMMIT_CHUNK)


@functools.lru_cache(maxsize=None)
def _commit_host(coeffs_bytes):
    """Σ_i c_i·G_i + blind·W of each column by the JAX package's host
    oracle, from the canonical values of the Montgomery limbs."""
    coeffs = np.frombuffer(coeffs_bytes, dtype=np.int32).reshape(
        16, COMMIT_COLS, 1 << Q_K).copy()
    srs = setup(Q_K, "cpu", cache_dir=None)
    plain = FP.from_mont(torch.as_tensor(coeffs)).numpy()
    out = []
    for i, blind in enumerate(COMMIT_BLINDS):
        c = jhost.msm(_ints(plain[:, i]), srs.g_host)
        out.append(jhost.add(c, jhost.scalar_mul(blind, srs.w_host))
                   if blind else c)
    return out


def test_commit_many_rows_equals_single_device(mesh_run):
    """Row blocks committed against the rank's block of the generators
    give the single-device commitments (affine, blinded) on every rank,
    which are the JAX host oracle's; the only collective is the MSM
    partials' gather, three coordinates of each of the 4 + 4 columns of
    the two passes."""
    D, inp, res = mesh_run
    want = _commit_want(inp["commit"].tobytes())
    assert len(want) == COMMIT_COLS and None not in want
    assert want == _commit_host(inp["commit"].tobytes())
    for got in res["commit"]:
        assert got["commitments"] == want
        assert got["collectives"] == {"all_gather": 3 * 8 * (D - 1)}


def test_eval_poly_rows_equals_eval_poly_and_jax(mesh_run):
    """The sum over ranks of the blocks' partials is `eval_poly` of the
    whole columns, which is the JAX `eval_poly` of the same limbs; one
    gather of D partials, a field element a column."""
    D, inp, res = mesh_run
    a, x = inp["ev"], inp["x"]
    want = eval_poly(FP, torch.as_tensor(a), torch.as_tensor(x)).numpy()
    want_jax = np.asarray(jntt.eval_poly(
        JFP, jnp.asarray(a.astype(np.uint32)),
        jnp.asarray(x.astype(np.uint32)))).astype(np.int64)
    np.testing.assert_array_equal(want.astype(np.int64), want_jax)
    for got in res["eval"]:
        np.testing.assert_array_equal(got["values"], want)
        assert got["collectives"] == {"all_gather": 3 * (D - 1)}


def test_quotient_coeff_equals_single_device(mesh_run):
    """Every rank's `quotient_coeff`, fed with its row blocks of the
    columns, equals the single-device one bit for bit (the same columns,
    challenges and chunking)."""
    _, _, res = mesh_run
    want = _quotient_want()
    assert want.shape == (16, 4 << Q_K) and want.any()
    for got in res["quotient"]:
        np.testing.assert_array_equal(got["q"], want)


def test_quotient_fold_gathers_nothing(mesh_run):
    """The fold lifts and holds n_ext/D rows a column, exchanges halos and
    gathers nothing; after it, the quotient's coefficients are the only
    gather: (D-1)/D of n_ext from each rank."""
    D, inp, res = mesh_run
    n_ext = (1 << Q_K) << inp["cs"].extension_factor_log2()
    for got in res["quotient"]:
        assert got["lifted"] == [n_ext // D] and got["folded"] == n_ext // D
        assert set(got["fold"]) == {"all_to_all", "permute"}
        assert got["after"]["all_gather"] == n_ext // D * (D - 1)
        assert set(got["after"]) == {"all_to_all", "all_gather"}


def test_launcher_raises_when_a_rank_raises():
    t0 = time.time()
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        run_on_mesh(paths.raise_on_rank, 2, 1, device="cpu", timeout_s=120)
    assert time.time() - t0 < 120


def test_launcher_raises_at_its_deadline():
    """Ranks still starting at the deadline are stopped and reported."""
    t0 = time.time()
    with pytest.raises(RankError, match="still running after"):
        run_on_mesh(paths.raise_on_rank, 2, 2, device="cpu", timeout_s=0.5)
    assert time.time() - t0 < 30


def test_backend_follows_the_device_map():
    assert backend_for(rank_devices(2, "cpu")) == "gloo"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"  # ranks share a card
    assert backend_for(["cuda", "cuda:0"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_devices(2)
