"""The port's CUDA kernels B1-B6 (and the loop forms B3s, B4s, B5l, B6h),
M1, A1, A2, P1 and P2 against their plain versions, and the mock prover on
the card against the CPU.

Every test here needs an NVIDIA GPU: without one each skips (the decision is
made in the `dev` fixture, not at import).  The machine with the card has no
JAX, so run them without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are made from seeds with numpy; the kernel runs on the card and its
plain version on the same inputs on the CPU.  Tolerance 0: the arithmetic
is exact and both keep canonical limbs.  P2's f32fma rounds once on the card
and twice in its plain version: rtol 1e-5 there, with equal infinities.
"""

import importlib
import os
import random

import numpy as np
import pytest
import torch

from tinyram_tpu_torch import kernels
from tinyram_tpu_torch.curve import cuda_affine
from tinyram_tpu_torch.curve import cuda_point as cp
from tinyram_tpu_torch.curve import host, vesta
from tinyram_tpu_torch.curve.msm import msm, msm_many
from tinyram_tpu_torch.curve.vesta import PointBatch, from_affine_host, to_affine_host
from tinyram_tpu_torch.field import FP, FQ
from tinyram_tpu_torch.field.cuda_mul import mont_mul, mont_mul_plain
from tinyram_tpu_torch.ipa.srs import _hash_to_curve
from tinyram_tpu_torch.poly import cuda_mxu, cuda_ntt, mxu_ntt
from tinyram_tpu_torch.poly.ntt import ntt
from tinyram_tpu_torch.tinyram import Imm, Instruction

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

pytestmark = pytest.mark.cuda

# curve/__init__ re-exports the function `msm` over the module name
tmsm = importlib.import_module("tinyram_tpu_torch.curve.msm")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    kernels.library()  # builds on first use; a failed build fails here
    return torch.device("cuda", 0)


def _limbs(shape, seed):
    """Canonical field elements (< 2^254) as (16, *shape) int32 on the CPU."""
    limbs = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(16,) + tuple(shape), dtype=np.int64)
    limbs[15] &= 0x3FFF
    return torch.as_tensor(limbs.astype(np.int32))


def _gpu_equals_cpu(got, want):
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("field", [FP, FQ], ids=["Fp", "Fq"])
def test_b1_mont_mul(dev, field):
    p = field.modulus
    edge = field.encode([0, 1, p - 1, p - 2, 2], to_mont=False)
    a = torch.cat([edge, _limbs((4099,), 1)], dim=1)
    b = torch.cat([edge.flip(1), _limbs((4099,), 2)], dim=1)
    before = mont_mul.launches
    _gpu_equals_cpu(mont_mul(a.to(dev), b.to(dev), field.params),
                    mont_mul_plain(a, b, field.params))
    assert mont_mul.launches == before + 1


@pytest.mark.parametrize("log_n", [9, 10, 11, 14])
@pytest.mark.parametrize("inverse", [False, True])
def test_b2_ntt(dev, log_n, inverse):
    x = _limbs((3, 1 << log_n), log_n)
    before = cuda_ntt.colntt.launches
    _gpu_equals_cpu(ntt(FP, x.to(dev), inverse), ntt(FP, x, inverse))
    assert cuda_ntt.colntt.launches > before


@pytest.mark.parametrize("inverse", [False, True])
def test_b2_ntt_2_19(dev, inverse):
    """Config 3's extended domain: one column of 2^19 points, rows of 2^10
    and of 2^9 with the cross multipliers between them."""
    x = _limbs((1, 1 << 19), 19)
    _gpu_equals_cpu(ntt(FP, x.to(dev), inverse), ntt(FP, x, inverse))


def test_b2_rows_with_multipliers(dev):
    x, mult, scale = _limbs((6, 256), 3), _limbs((3, 256), 4), _limbs((), 5)
    _gpu_equals_cpu(
        cuda_ntt.colntt(x.to(dev), FP, False, mult.to(dev), scale.to(dev)),
        cuda_ntt.colntt(x, FP, False, mult, scale))


@pytest.fixture(scope="module")
def points():
    """A projective batch with identity lanes, a second one, and a mask."""
    pool = [_hash_to_curve(b"torch-cuda-test", i) for i in range(64)]
    rng = np.random.default_rng(6)
    n = 1000

    def batch(seed):
        pts = [None if i % 9 == 4 else pool[int(j)]
               for i, j in enumerate(np.random.default_rng(seed).integers(0, 64, n))]
        aff = from_affine_host(pts)
        z = FQ.encode([int(v) | 1 for v in rng.integers(1, 1 << 62, n)])
        ident = FQ.is_zero(aff.z)
        return PointBatch(FQ.mul(aff.x, z), FQ.select(ident, aff.y, FQ.mul(aff.y, z)),
                          FQ.mul(aff.z, z))

    qa = from_affine_host([pool[i % 64] for i in range(n)])
    return batch(7), batch(8), qa, torch.as_tensor(rng.random(n) < 0.5)


def _on(p, dev):
    return PointBatch(*(c.to(dev) for c in p))


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_b3_to_b6_points(dev, points):
    p, q, qa, mask = points
    dp, dq, dm = _on(p, dev), _on(q, dev), mask.to(dev)
    _equal(cp.padd_select_mixed(dm, dp, qa.x.to(dev), qa.y.to(dev)),
           cp.madd_select_plain(mask, p, qa.x, qa.y))
    _equal(cp.padd(dp, dq), cp.padd_plain(p, q))
    _equal(cp.padd_select(dm, dp, dq), cp.padd_select_plain(mask, p, q))
    _equal(cp.pdouble(dp), cp.pdouble_plain(p))


@pytest.mark.parametrize("times", [0, 1, 12, 15])
@pytest.mark.parametrize("n", [1, 65, 1000])
def test_b6_count(dev, points, times, n):
    """B6 with a count: `times` doublings in one launch (none for 0)."""
    p = PointBatch(*(c[:, :n] for c in points[0]))
    before = cp.pdouble.launches
    _equal(cp.pdouble(_on(p, dev), times=times), cp.pdouble_plain(p, times))
    assert cp.pdouble.launches == before + (times > 0)


@pytest.mark.parametrize("A,H,S", [(1, 1, 1), (1, 65, 2), (3, 5, 7),
                                   (4, 64, 64), (2, 256, 128)])
def test_b4s_suffix_scan(dev, points, A, H, S):
    """B4s against its plain loop over (A, H, S) buckets with identity
    lanes, read as the msm reads them: a view of (16, A, H*S + 2) (tiles of
    the layout pass cut by H and S); on lane 0 the buckets P and -P take
    acc through the identity.  (4, 64, 64) is config 2's window (c = 13),
    (2, 256, 128) config 3's (c = 16: a stride of 2^15 + 2 words)."""
    p, q = points[0], points[1]
    idx = np.random.default_rng(A * H * S).integers(0, 1000, size=A * (H * S + 2))
    full = PointBatch(*(c[:, idx].reshape(16, A, H * S + 2)
                        for c in (p if S % 2 else q)))
    if S > 1:  # lane 0: P at step S-1, -P at step S-2
        pt = PointBatch(*(coord[:, :1] for coord in p))
        for coord, pos, neg in zip(full, pt, vesta.neg(pt)):
            coord[:, 0, S - 1], coord[:, 0, S - 2] = pos[:, 0], neg[:, 0]

    def buckets(x):
        return PointBatch(*(coord[..., :H * S].reshape(16, A, H, S) for coord in x))

    before = cp.padd_suffix_scan.launches
    got = cp.padd_suffix_scan(buckets(_on(full, dev)))
    assert cp.padd_suffix_scan.launches == before + 1
    want = cp.suffix_scan_plain(buckets(full))
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("nw,c,n", [(1, 1, 1), (3, 2, 5), (20, 13, 4),
                                    (4, 3, 70), (16, 16, 4)])
def test_b6h_horner(dev, points, group, nw, c, n):
    """B6h against its plain loop, one thread or a group of four per lane;
    n = 5 and 70 leave a ragged warp at the group of four."""
    p, q = points[0], points[1]
    idx = np.random.default_rng(nw * n + c).integers(0, 1000, size=nw * n)
    ws = PointBatch(*(coord[:, idx].reshape(16, nw, n)
                      for coord in (q if c % 2 else p)))
    before = cp.pdouble_horner.launches
    got = cp.pdouble_horner(_on(ws, dev), c, group=group)
    assert cp.pdouble_horner.launches == before + 1
    _equal(got, cp.horner_plain(ws, c))


def _mask(kind, n, seed):
    if kind == "none":
        return torch.zeros(n, dtype=torch.bool)
    if kind == "all":
        return torch.ones(n, dtype=torch.bool)
    return torch.as_tensor(np.random.default_rng(seed).random(n) < 0.5)


@pytest.mark.parametrize("kind", ["none", "all", "mixed"])
@pytest.mark.parametrize("n", [1, 65, 1000])
def test_b3_b5_one_step_masks(dev, points, kind, n):
    """The one-step B3 (B3s's kernel with L = 1) and B5: masks all-false,
    all-true and mixed; n = 1 and n not a multiple of the 64-lane block;
    identity lanes in p and q."""
    p, q, qa = (PointBatch(*(c[:, :n] for c in b)) for b in points[:3])
    mask = _mask(kind, n, n)
    dp, dq, dm = _on(p, dev), _on(q, dev), mask.to(dev)
    b3, b5 = cp.padd_select_mixed.launches, cp.padd_select.launches
    _equal(cp.padd_select_mixed(dm, dp, qa.x.to(dev), qa.y.to(dev)),
           cp.madd_select_plain(mask, p, qa.x, qa.y))
    _equal(cp.padd_select(dm, dp, dq), cp.padd_select_plain(mask, p, q))
    assert (cp.padd_select_mixed.launches, cp.padd_select.launches) == (b3 + 1, b5 + 1)


@pytest.fixture(scope="module")
def pool():
    pts = [_hash_to_curve(b"torch-cuda-loops", i) for i in range(8)]
    return pts + [host.neg(pt) for pt in pts]


@pytest.mark.parametrize("L,M", [(1, 1), (1, 65), (6, 130), (8, 1000), (128, 1000)])
def test_b3s_scan(dev, pool, L, M):
    """B3s against its plain loop: columns of `same` all false, all true
    and mixed, and an accumulator that P + (-P) turns into the identity."""
    rng = np.random.default_rng(L * M)
    idx = rng.integers(0, 8, size=(L, M))
    same = rng.random((L, M)) < 0.5
    same[:, 0], same[:, -1] = False, True
    neg = np.zeros((L, M), dtype=bool)
    if L > 3:  # lanes 1..4: acc = P at step 1, then P + (-P) at step 2
        same[1, 1:5], same[2, 1:5] = False, True
        idx[2, 1:5] = idx[1, 1:5]
        neg[2, 1:5] = True
    aff = [from_affine_host([pool[int(idx[s, m]) + 8 * bool(neg[s, m])]
                             for m in range(M)]) for s in range(L)]
    sx = torch.stack([a.x for a in aff])
    sy = torch.stack([a.y for a in aff])
    same = torch.as_tensor(same)
    before = cp.padd_select_mixed_scan.launches
    got = cp.padd_select_mixed_scan(same.to(dev), sx.to(dev), sy.to(dev))
    assert cp.padd_select_mixed_scan.launches == before + 1
    want = cp.madd_select_scan_plain(same, sx, sy)
    _equal(got, want)
    if L > 3:
        assert (want.z[2, :, 1:5] == 0).all()


@pytest.mark.parametrize("R,n", [(1, 1), (1, 65), (8, 130), (8, 1000)])
def test_b5l_ladder(dev, points, R, n):
    """B5l against its plain loop: identity points, bits all false and all
    true on some lanes."""
    p = PointBatch(*(c[:, :n] for c in points[0]))
    bits = np.random.default_rng(R * n).random((R, n)) < 0.5
    bits[:, 0] = True
    if n > 1:
        bits[:, 1] = False
    bits = torch.as_tensor(bits)
    before = cp.padd_select_ladder.launches
    got = cp.padd_select_ladder(bits.to(dev), _on(p, dev))
    assert cp.padd_select_ladder.launches == before + 1
    _equal(got, cp.ladder_plain(bits, p))


@pytest.mark.parametrize("n", [100, (1 << 15) + 40])
def test_msm_on_card_matches_host(dev, n):
    """Both MSM paths on the card: bit-serial (B6, B5) and Pippenger (B3-B6)."""
    pool = [_hash_to_curve(b"torch-cuda-msm", i) for i in range(8)]
    rng = np.random.default_rng(n)
    idx = rng.integers(-1, 8, n)
    pts = [None if j < 0 else pool[int(j)] for j in idx]
    sc = [int(v) for v in rng.integers(0, 1 << 62, n)]
    sums = {}
    for s, j in zip(sc, idx):
        if j >= 0:
            sums[int(j)] = (sums.get(int(j), 0) + s) % FP.modulus
    want = None
    for j, s in sums.items():
        want = host.add(want, host.scalar_mul(s, pool[j]))
    got = msm(FP.encode(sc, to_mont=False, device=dev), from_affine_host(pts, dev))
    assert to_affine_host(PointBatch(*(c[:, None] for c in got)))[0] == want
    if n < 1000:
        stack = FP.encode(sc, to_mont=False, device=dev)[:, None].expand(16, 3, n)
        assert to_affine_host(msm_many(stack.contiguous(),
                                       from_affine_host(pts, dev))) == [want] * 3


@pytest.mark.parametrize("log_r", range(1, 8))
@pytest.mark.parametrize("inverse", [False, True])
def test_m1_dft_stage(dev, log_r, inverse):
    """M1 against its plain version at every radix 2..128, on a (16, R, L)
    array and on the transposed view of rows (what the four-step passes)."""
    R = 1 << log_r
    x = _limbs((R, 37), log_r)
    want = mxu_ntt.dft_stage_plain(x, FP, log_r, inverse)
    before = cuda_mxu.dft_stage_m1.launches
    _gpu_equals_cpu(cuda_mxu.dft_stage_m1(x.to(dev), "Fp", log_r, inverse),
                    want)
    rows = x.transpose(1, 2).contiguous().to(dev).transpose(1, 2)
    got = cuda_mxu.dft_stage_m1(rows, "Fp", log_r, inverse)
    assert got.stride() == rows.stride()
    _gpu_equals_cpu(got, want)
    assert cuda_mxu.dft_stage_m1.launches == before + 2


@pytest.mark.parametrize("log_n", [9, 12, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_mxu_equals_b2(dev, log_n, inverse):
    x = _limbs((2, 1 << log_n), log_n).to(dev)
    before = cuda_mxu.dft_stage_m1.launches
    assert torch.equal(ntt(FP, x, inverse, method="mxu"), ntt(FP, x, inverse))
    assert cuda_mxu.dft_stage_m1.launches > before


@pytest.mark.parametrize("n", [1, 601, 1 << 17])
def test_a2_batch_inverse(dev, n):
    """A2 against its plain product tree, zeros left in (their stop-level
    nodes give zero) and substituted lanes."""
    d = _limbs((n,), n)
    d[:, n // 3] = 0
    if n > 8:
        d[:, 7] = FQ.ones((1,))[:, 0]
    before = cuda_affine.batch_inverse.launches
    _gpu_equals_cpu(cuda_affine.batch_inverse(d.to(dev)), tmsm.batch_inv(d))
    assert cuda_affine.batch_inverse.launches == before + 1


@pytest.mark.parametrize("L,M", [(1, 1), (5, 600), (8, 1000)])
def test_a1_affine_scan(dev, pool, L, M):
    """A1 against its plain loop: restarts, repeated points (doubling) and
    P then -P (cancel to the identity), over lanes of several blocks."""
    rng = np.random.default_rng(L * M + 1)
    idx = rng.integers(0, 16, size=(L, M))
    same = rng.random((L, M)) < 0.6
    if L > 2:
        idx[1] = idx[0]  # doubling where same[1]
        idx[2, : M // 2] = idx[1, : M // 2] ^ 8  # -P after 2P: no cancel;
        idx[2, M // 2:] = idx[0, M // 2:] ^ 8  # -P after a restart: cancel
        same[1, M // 2:] = False
    aff = [from_affine_host([pool[int(i)] for i in row]) for row in idx]
    sx = torch.stack([a.x for a in aff])
    sy = torch.stack([a.y for a in aff])
    same = torch.as_tensor(same)
    before = cuda_affine.affine_scan.launches
    got = cuda_affine.affine_scan(same.to(dev), sx.to(dev), sy.to(dev))
    assert cuda_affine.affine_scan.launches == before + 1
    want = tmsm.affine_scan_plain(same, sx, sy)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_msm_affine_on_card_matches_projective(dev):
    """The Pippenger path with the affine scan (A1) against the projective
    one (B3s), for msm and msm_many."""
    n = (1 << 15) + 40
    pool = [_hash_to_curve(b"torch-cuda-msm", i) for i in range(8)]
    rng = np.random.default_rng(n)
    pts = from_affine_host([None if j < 0 else pool[int(j)]
                            for j in rng.integers(-1, 8, n)], dev)
    sc = FP.encode([int(v) for v in rng.integers(0, 1 << 62, 2 * n)],
                   to_mont=False, device=dev).reshape(16, 2, n)
    before = cuda_affine.affine_scan.launches
    for fn, s in ((msm, sc[:, 0]), (msm_many, sc)):
        got = fn(s, pts, affine=True)
        want = fn(s, pts)
        assert to_affine_host(PointBatch(*(c.reshape(16, -1) for c in got))) \
            == to_affine_host(PointBatch(*(c.reshape(16, -1) for c in want)))
    assert cuda_affine.affine_scan.launches > before


def test_w8_proof_on_card_equals_jax_bytes(dev):
    """gen_proof_and_verify on the card (setup, keygen, prove, verify) for
    the Answer-only W=8 program: the proof is the JAX package's recorded
    proof (tests/data/torch_golden_w8.npz) byte for byte, and verifies."""
    from tinyram_tpu_torch.tinyram import Imm, Instruction, gen_proof_and_verify

    class SeededRng:
        def __init__(self, seed):
            self._r = random.Random(seed)

        def randbelow(self, n):
            return self._r.randrange(n)

    rec = np.load(os.path.join(os.path.dirname(__file__), "data",
                               "torch_golden_w8.npz"))
    prog = [Instruction("Answer", None, None, Imm(0))]
    _, proof, ok = gen_proof_and_verify(8, 8, prog, device=dev,
                                        rng=SeededRng(1))
    assert ok
    assert proof == rec["proof_answer"].tobytes()


@pytest.mark.parametrize("reps", [16, 64])
@pytest.mark.parametrize("op", ["add", "mul", "mulmask"])
def test_p1_probe(dev, op, reps):
    from tinyram_tpu_torch import probes

    a, b = probes.p1_inputs(shape=(16, 4096), seed=reps, device="cpu")
    before = probes.vpu_chain.launches
    _gpu_equals_cpu(probes.vpu_chain(op, a.to(dev), b.to(dev), reps),
                    probes.vpu_chain(op, a, b, reps))
    assert probes.vpu_chain.launches == before + 1


@pytest.mark.parametrize("op", ["u32mul", "u32add", "u32shift", "f32mul",
                                "f32fma"])
def test_p2_probe(dev, op):
    from tinyram_tpu_torch import probes

    a, b = probes.p2_inputs(op, shape=(512, 128), seed=3, device="cpu")
    got = probes.vpu_ops(op, a.to(dev), b.to(dev)).cpu()
    want = probes.vpu_ops(op, a, b)
    if op == "f32fma":
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=0)
    else:
        assert torch.equal(got, want)


def test_mock_on_card_equals_cpu(dev):
    """W=8 forged witnesses: the same Failure list on the card and on the
    CPU (payloads of tests/test_proof_negative.py)."""
    from tinyram_tpu_torch.plonk import MockProver
    from tinyram_tpu_torch.tinyram import Reg, TinyRamCircuit, eval_program

    circ = TinyRamCircuit(8, 8)
    prog = [Instruction("Mov", 2, None, Imm(55)),
            Instruction("Shr", 3, 2, Imm(2)),
            Instruction("Answer", None, None, Reg(3))]
    tr = eval_program(prog, 8, 8)

    def forged(device, family, payload):
        asg = circ.assignment(tr, device=device)
        row = len(tr) + 1
        for name, off, value in [(f"out.{family}", 0, 1)] + payload:
            col = circ.tcs.col.advice[name]
            vals = FP.decode(asg.get(col))
            vals[row + off] = value
            asg.set(col, np.array(vals, dtype=object))
        return asg

    assert circ.mock_prove(tr, device=dev) == []
    for family, payload in [("and", [("tv_c", 0, 7)]), ("sum", [("tv_a", 0, 5)]),
                            ("flag4", [("flag", 1, 1)])]:
        before = mont_mul.launches
        on_card = MockProver(circ.tcs.cs, forged(dev, family, payload)).verify()
        assert mont_mul.launches > before
        on_cpu = MockProver(circ.tcs.cs, forged("cpu", family, payload)).verify()
        assert on_card and [str(f) for f in on_card] == [str(f) for f in on_cpu]
