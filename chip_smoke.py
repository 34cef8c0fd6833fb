#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tinyram_tpu_torch) on one GPU.

Usage: python3 chip_smoke.py   (no arguments; needs one CUDA device)

1. Prints the card's name and power limit, builds the CUDA kernels and
   reads their SASS (`cuobjdump -sass`) for the instruction counts of the
   compute bounds: each kernel's integer instructions by pipe (IMAD-class
   without register moves; IADD3/LOP3/SHF/LEA) over the card's published
   64-lane integer rate, against its bytes over 3.35 TB/s.  Kernel times
   are CUDA-graph replays (no host gap between launches); the plain
   versions are timed as Python issues them.
2. Probes: drives the op-rate probe path (`probes.measure`, what
   `python -m tinyram_tpu_torch.probes` runs) with the launch counts reset
   just before it, then holds P1 and P2, every op at the JAX scripts'
   shapes, against their plain versions on the card (u32 ops and f32mul
   exact; f32fma rtol 1e-5 with equal infinities), with G ops/s and the
   SASS instructions of the op per chain step.
3. Runs each kernel B1-B6 on the card at config 2's shapes and holds
   it against its plain PyTorch version on the same inputs: the outputs
   must be equal limb for limb (tolerance 0: the arithmetic is exact).  So
   are the MSM's loops in one launch each: the bucket scan B3s (128 steps
   of B3 at 2^15 lanes, config 2's `same` mask), the ladder B5l (256 steps
   of B6 and B5 at 2^15 lanes), the weighted reduce's suffix scan B4s (64
   steps of two B4 at 20 x 64 x 64 lanes) and the window combine B6h (20
   windows of 13 doublings and one add, at 64 and 4 lanes), each timed
   beside the Python loop of one-step launches it replaces; B6 with a count
   (12 doublings at 1280 lanes) beside its loop too.  B6h runs with one
   thread and with a group of four per lane, and on one lane with one
   thread: the latency of one product in its chain of dependent products.
   The one-step B3 and B5 are timed at mask shares 0, 5, 50 and 100 %
   (`scripts/torch_point_sweep.py`).  The point kernels are bounded by the
   Montgomery products they need, each at the SASS of a product loop.
4. Drives the main path: BASELINE config 2 (the arithmetic/bitwise loop of
   ~2^12 steps at W=24, 8 registers, k=14) through TinyRamCircuit: SRS
   setup, keygen, witness, create_proof, verify; the proof must verify and
   must be rejected for answer + 1.  The launch counts are reset just
   before the proof; each of B1, B2, B3s, B4, B4s, B5, B5l, B6, B6h must
   be > 0 after it, the one-step B3 0 (the scan replaced it), B4s as many
   as B6h (one each per Pippenger MSM) and B6 at most two per B6h (the
   doubling chains, no Horner steps).
5. The mock prover on config 2 at full width on the card: the clean trace
   gives no failure, one forged advice cell (tv_c on an And row) gives a
   failure named after the "and" gate; B1 launches > 0 during the mock.
6. The 13 negative proofs at W=8 (payloads of tests/test_proof_negative.py,
   copied: that file imports JAX): for each family the mock names the
   family and the real proof made on the card is rejected; the clean proof
   is accepted.  One SRS and one pk serve all of them.
7. W=16 (k=10): one proof verifies and answer + 1 is rejected.
8. The batch verifier: the config-2 proof queued twice is accepted; with
   the answer + 1 inputs beside it, rejected, per proof [True, False].
9. The key file: the config-2 pk saved with `save_pk` to chiprun_out/ and
   loaded with `load_pk` proves the same bytes under the seeded stream.
10. Proves the W=8 Answer-only program on the card under the seeded random
    stream of tests/data/torch_golden_w8.npz and checks that the proof
    bytes equal the JAX package's recorded proof.
11. BASELINE config 3 (2^16 steps of the full ISA with memory, W=24, 8
    registers, k=17) through `tinyram.prove_config.prove_config(3)`, what
    `scripts/torch_prove_config3.py --mock --prove` runs: the Python and the
    native emulator's traces must be equal, the mock on the card must find
    no failure, the proof must verify and answer + 1 must be rejected; the
    launch counts are reset just before the proof and each of B1, B2, B3s,
    B4, B4s, B5, B6, B6h must be > 0 after it (B3 0, B4s as many as B6h,
    B6 at most two per B6h).  It runs after the config-2 phases, in the
    same process, so its first proof is the first at k = 17 with the
    kernels already built and loaded; its SRS (k=17) hashes, in a pool of
    processes, the generators past config 2's 2^14.  Then every kernel of
    that path at config 3's shapes (the widest B1 launch of its proof,
    B2's rows of a 64-column lift to 2^19, the 64-column commit pass at
    c = 16) against its plain version, on a seeded sample of lanes where
    the plain version would take minutes.
12. `entry()` (tinyram_tpu_torch/entry.py, the twin of
    `__graft_entry__.entry()`: NTT -> multiply -> inverse NTT at 2^12) on
    the card, equal bit for bit to the same function on the CPU; B1 and B2
    must launch.
13. `verify_msm` (the twin of scripts/verify_msm_tpu.py) at 2^16 (c = 15:
    every case against the host oracle) and at 2^20 (c = 16: all-equal and
    selector-like against the oracle, random and edge against the sum of
    their halves' MSMs at c = 13), `msm` and `msm_many` with the
    affine-input check on; `setup(20)` (the SRS hashed past 2^17 in the
    pool, cached in build/cache/) is timed on its own between them.  Then
    B3s and B4s at those two MSMs' shapes against their plain versions.
14. The throughput steps of `python -m tinyram_tpu_torch.bench` (MSM at
    2^16 and 2^20, modmul at 2^18, NTT at 2^20 and 16 x 2^18); its JSON
    line is printed.  In 12-14 the counts are reset before each path and
    every kernel of it must launch.
15. The sharded paths (`tinyram_tpu_torch/shard/`, `shard_phase`), every
    rank a process on the one card: `dryrun_multichip(2)` and `(4)`, a rank
    made to raise, the sharded NTT of a (16, 2^20) column at D = 2 and 4,
    the sharded MSM over 2^18 generators at D = 2, config 2 proved by
    `create_proof(mesh=)` at D = 2 and at D = 4 (the bytes of phase 4's
    proof on every rank; every coefficient column a row block: each
    phase's all-gather exactly `shard.paths.gather_pattern`'s, none while
    the constraints fold, every transform split), and the scaling report
    at D = 1, 2, 4.  Each path's counts are reset in every rank before it,
    summed over the ranks, and must show its kernels; each proof's rank
    prints its seven phase seconds, its peak, the peak at each phase's end
    and the collectives of every phase.
16. The digit-matmul NTT (M1) and the batched-affine MSM (A1, A2), with
    the counts reset before each path (`mxu_affine_phase`): M1 against its
    plain version on a seeded sample of 64 columns at every stage shape of
    a 2^20, a 2^16 and a 16 x 2^18 transform (R = 128, 64, 32, 16), with
    its int8 bound and `torch._int_mm` of the 2^20 stages' digit product
    alone; the `bench_mxu_ntt` twin (mxu equal to B2 bit for bit, the
    inverse round trip, both rates); A2 on 2^17 lanes with substituted
    lanes (every d·d^-1 is one) and with zeros left in; A1 on 256 sampled
    lanes of the affine plan of 2^20 (L = 32, M = 2^17) and on every lane
    of config 3's commit scan (L = 128, M = 2^15) against B3s as points,
    each timed beside B3s; `msm` and `msm_many` with `affine=True` at 2^16
    and 2^20 over `setup(20)`'s generators, equal to `affine=False` (and
    at 2^16 to the host oracle); the `bench_msm` twin at 2^12 and 2^16;
    and config 2 proved by `create_proof(ntt_method="mxu",
    msm_affine=True)`, which must give phase 4's bytes, verify, reject
    answer + 1, launch M1 and A1 and no B2.  The default config-2 proof
    of phase 4 must have launched none of M1, A1, A2.

Prints the per-phase seconds and launch counts, the kernels' JSON line
(each kernel at config 2's shapes, its launches in one config-2 proof and,
as "launches_config3", in one config-3 proof, and as "launches_paths" in
each path of 12-16; M1, A1 and A2 at phase 16's shapes, with the launches
of the mxu/affine proof (A2: of the bench_msm twin)), and as its last line
{"ok": true, "device": {...}}.  Any failure raises (exit code 1) before
the last line; without a CUDA device it exits 1 too.
A detailed report goes to chiprun_out/chip_smoke_report.json.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
SEED = 0  # inputs of the kernel checks and the proof's random stream

KERNELS = {  # id -> (name, source, TPU kernel it replaces)
    "B1": ("mont_mul", "tinyram_tpu_torch/csrc/mont_mul.cu",
           "tinyram_tpu/field/pallas_mul.py:134"),
    "B2": ("ntt_rows", "tinyram_tpu_torch/csrc/ntt.cu",
           "tinyram_tpu/poly/pallas_ntt.py:170"),
    "B3": ("madd_select", "tinyram_tpu_torch/csrc/point.cu",
           "tinyram_tpu/curve/pallas_point.py:299"),
    "B3s": ("madd_select_scan", "tinyram_tpu_torch/csrc/point.cu",
            "tinyram_tpu/curve/pallas_point.py:299"),
    "B4": ("padd", "tinyram_tpu_torch/csrc/point.cu",
           "tinyram_tpu/curve/pallas_point.py:255"),
    "B4s": ("padd_suffix_scan", "tinyram_tpu_torch/csrc/point.cu",
            "tinyram_tpu/curve/pallas_point.py:255"),
    "B5": ("padd_select", "tinyram_tpu_torch/csrc/point.cu",
           "tinyram_tpu/curve/pallas_point.py:274"),
    "B5l": ("padd_select_ladder", "tinyram_tpu_torch/csrc/point.cu",
            "tinyram_tpu/curve/pallas_point.py:274"),
    "B6": ("pdouble", "tinyram_tpu_torch/csrc/point.cu",
           "tinyram_tpu/curve/pallas_point.py:324"),
    "B6h": ("pdouble_horner", "tinyram_tpu_torch/csrc/point.cu",
            "tinyram_tpu/curve/pallas_point.py:324"),
    "M1": ("mxu_dft_stage", "tinyram_tpu_torch/csrc/mxu_ntt.cu",
           "tinyram_tpu/poly/mxu_ntt.py:152"),
    "A1": ("affine_bucket_scan", "tinyram_tpu_torch/csrc/affine.cu",
           "tinyram_tpu/curve/msm.py:351"),
    "A2": ("batch_inv", "tinyram_tpu_torch/csrc/affine.cu",
           "tinyram_tpu/curve/msm.py:239"),
    "P1": ("vpu_chain", "tinyram_tpu_torch/csrc/vpu_probe.cu",
           "scripts/bench_vpu.py:45"),
    "P2": ("vpu_ops", "tinyram_tpu_torch/csrc/vpu_probe.cu",
           "scripts/bench_vpu_ops.py:51"),
}
# launched by a config-2 proof (the one-step B3 is not: B3s replaced it)
PROOF_KERNELS = ("B1", "B2", "B3s", "B4", "B4s", "B5", "B5l", "B6", "B6h")
# launched by a config-3 proof: every MSM there is past 2^15 lanes, so none
# takes the ladder B5l
CONFIG3_KERNELS = ("B1", "B2", "B3s", "B4", "B4s", "B5", "B6", "B6h")
# launched by every Pippenger MSM (verify_msm's runs), and by the bench's
# throughput steps (its MSMs, modmul and NTTs)
MSM_KERNELS = ("B3s", "B4", "B4s", "B5", "B6", "B6h")
BENCH_KERNELS = ("B1", "B2") + MSM_KERNELS
# launched by the config-2 proof at D = 2: its local transforms have 128-256
# points, under B2's 512, so no B2
SHARD_PROOF_KERNELS = ("B1", "B3s", "B4", "B4s", "B5", "B5l", "B6h")
# phase 16's kernels (new device code: the JAX computes them in XLA) and the
# path whose launches their rows report
NEW_KERNELS = {"M1": "config2 proof mxu+affine",
               "A1": "config2 proof mxu+affine", "A2": "bench_msm 2^12, 2^16"}
# the probe case each of P1, P2 reports in the kernels line
PROBE_ROW = {"P1": ("mul", 512), "P2": ("u32mul", 256)}
# SASS function of each kernel (a part of its mangled name)
SASS_NAME = {"B1": "15mont_mul_kernelILi0E", "B3": "16madd_scan_kernel",
             "B3s": "16madd_scan_kernel", "B4": "11padd_kernel",
             "B4s": "18suffix_scan_kernel", "B5": "18padd_select_kernel",
             "B5l": "13ladder_kernel", "B6": "14pdouble_kernel",
             "B6h": "13horner_kernelILi4E"}
# Montgomery products of one RCB16 formula: add (Alg. 7), mixed add (8),
# doubling (9)
ADD, MADD, DBL = 12, 11, 8
# the point kernels with product loops, and the products of one pass of
# their kernel's body (B6h's group form has no product loop: it is bounded
# at B4's, the same mont_mul_cc)
STAGED = {"B3": MADD, "B4": ADD, "B4s": 2 * ADD, "B5": ADD, "B5l": DBL + ADD,
          "B6": DBL}

HBM_BYTES_PER_S = 3.35e12  # published H100 SXM memory rate (700 W part)
F32_PER_S = 67e12 / 2  # published float32 rate, 67 TFLOP/s, as FMUL/FFMA per s
INT32_PER_S = F32_PER_S / 2  # 64 integer lanes per SM against 128 float32
FE_BYTES = 64  # one field element: 16 limbs in int32
MOCK_FORGE = ("and", "tv_c")
# the SASS opcode of each probe op's chain step
CHAIN_OPCODE = {"add": "IADD3", "u32add": "IADD3", "mul": "IMAD",
                "u32mul": "IMAD", "mulmask": "IMAD", "u32shift": "SHF.R.U32.HI",
                "f32mul": "FMUL", "f32fma": "FFMA"}  # gate family and the advice column forged


class SeededRng:
    """`randbelow(n)` from a seeded `random.Random` (the stream the golden
    fixture's JAX proofs were made with)."""

    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)


# (family, [(column, row_offset_from_pad_row, value), ...]): each payload
# trips a failure whose gate name starts with the family name.  A copy of
# tests/test_proof_negative.py's FAMILY_PAYLOADS.
FAMILY_PAYLOADS = [
    ("and", [("tv_c", 0, 7)]),
    ("xor", [("tv_c", 0, 7)]),
    ("or", [("tv_c", 0, 7)]),
    ("sum", [("tv_a", 0, 5)]),
    ("ssum", [("tv_a", 0, 5)]),
    ("prod", [("tv_c", 0, 7)]),
    ("sprod", [("tv_c", 0, 7)]),
    ("mod", [("tv_a", 0, 5)]),
    ("shift", [("tv_a", 0, 5)]),
    ("flag1", [("tv_c", 0, 7), ("flag", 1, 1)]),
    ("flag2", [("tv_a", 0, 5)]),
    ("flag3", [("tv_a", 0, 5)]),
    ("flag4", [("flag", 1, 1)]),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def naming(failures, family: str) -> list:
    """The failures whose gate name starts with `family`."""
    return [f for f in failures
            if f.name.split("#")[0].split(".")[0].startswith(family)]


def forged_assignment(circ, tr, family, payload, dev):
    """tests/test_proof_negative.py's `_forged_assignment` on `dev`:
    activate `out.<family>` on the first padding row, apply the payload."""
    import numpy as np

    from tinyram_tpu_torch.field import FP

    row = len(tr) + 1
    asg = circ.assignment(tr, dev)
    for name, off, value in [(f"out.{family}", 0, 1)] + payload:
        col = circ.tcs.col.advice[name]
        vals = FP.decode(asg.get(col))
        vals[row + off] = value
        asg.set(col, np.array(vals, dtype=object))
    return asg


# ----------------------------------------------------------------- bounds


def imad_count(opcodes) -> int:
    """IMAD-class arithmetic (IMAD, .WIDE, .HI, .X) in a Counter of SASS
    opcodes: the work of the integer multiply pipe.  IMAD.MOV, a register
    move the compiler puts on that pipe, is not work the function needs and
    is left out."""
    return sum(v for k, v in opcodes.items()
               if k.startswith("IMAD") and not k.startswith("IMAD.MOV"))


def alu_count(opcodes) -> int:
    """IADD3/LOP3/SHF/LEA in a Counter of SASS opcodes (the carries, masks
    and shifts of limb arithmetic): the work of the 64-lane integer pipe."""
    return sum(v for k, v in opcodes.items()
               if k.split(".")[0] in ("IADD3", "LOP3", "SHF", "LEA"))


def pipe_ms(opcodes, elements: int) -> float:
    """Least time of `elements` threads each issuing the instructions of
    `opcodes`, by pipe at the card's published rates: IMAD-class (moves
    left out) on the 64-lane integer multiply pipe, IADD3/LOP3/SHF/LEA on
    the 64-lane integer pipe, FMUL/FFMA/FADD at the 128-lane float32
    rate."""
    imad = imad_count(opcodes)
    alu = alu_count(opcodes)
    fp = sum(v for k, v in opcodes.items()
             if k.split(".")[0] in ("FMUL", "FFMA", "FADD"))
    return max(imad / INT32_PER_S, alu / INT32_PER_S,
               fp / F32_PER_S) * elements * 1e3


def bound(nbytes: float, ops_ms: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def product_loop(ins) -> tuple:
    """(opcode counts of one Montgomery product, number of product loops)
    in the SASS of a staged kernel (B3, B5 and their forms): its product
    loops are the innermost loops (a backward branch and the instructions
    from its target to it) that hold IMAD.HI; the counts are their mean."""
    import collections
    import re

    loops = []
    for addr, op, args in ins:
        hexes = re.findall(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else []
        if hexes and int(hexes[-1], 16) <= addr:
            loops.append((int(hexes[-1], 16), addr))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    bodies = [collections.Counter(op for addr, op, _ in ins if a <= addr <= b)
              for a, b in inner]
    bodies = [c for c in bodies if c["IMAD.HI.U32"]]
    if not bodies:
        raise AssertionError("SASS: no product loop found")
    mean = collections.Counter()
    for c in bodies:
        mean.update(c)
    return {k: v / len(bodies) for k, v in mean.items()}, len(bodies)


def sass_of(funcs: dict, part: str):
    hits = [c for name, c in funcs.items() if part in name]
    if len(hits) != 1:
        raise AssertionError(f"SASS: {len(hits)} kernels match {part!r}")
    return hits[0]


# ----------------------------------------------------------------- phases


def probe_phase(dev, report, funcs) -> dict:
    """P1 and P2: the probe path with counts, then each case against its
    plain version on the card."""
    import torch

    from tinyram_tpu_torch import kernels, probes

    kernels.reset_launch_counts()
    t0 = time.time()
    rates = probes.measure(dev)
    t_measure = time.time() - t0
    launches = kernels.launch_counts()
    log(f"[probe] probe path {t_measure:.2f}s, launches "
        f"P1={launches['P1']} P2={launches['P2']}")
    for kid in ("P1", "P2"):
        if launches[kid] == 0:
            raise AssertionError(f"{kid} never launched by the probe path")

    out = {"launches": {k: launches[k] for k in ("P1", "P2")}, "cases": []}
    for (kid, fn, op, reps), rate in zip(probes.cases(), rates):
        a, b = (probes.p1_inputs(device=dev) if kid == "P1"
                else probes.p2_inputs(op, device=dev))
        got = fn(op, a, b, reps)
        want = probes.chain_plain(op, a, b, reps)
        sync()
        if op in probes.F32_OPS:
            same_inf = bool(torch.equal(torch.isinf(got), torch.isinf(want)))
            fin = torch.isfinite(want)
            diff = (got[fin].double() - want[fin].double()).abs()
            err = float(diff.max()) if diff.numel() else 0.0
            rel = float((diff / want[fin].double().abs()).max()) if diff.numel() else 0.0
            ok = same_inf and (rel == 0.0 if op == "f32mul" else rel <= 1e-5)
            finite = int(fin.sum())
        else:
            mask = 0xFFFFFFFF
            err = int(((got.to(torch.int64) & mask)
                       - (want.to(torch.int64) & mask)).abs().max())
            rel, ok, finite = 0.0, err == 0, got.numel()
        sass, short = (sass_of(funcs, f"{'f32' if op in probes.F32_OPS else 'u32'}"
                                      f"_chain_kernelILi{probes._CODE[op]}ELi{r}EE")
                       for r in (reps, 16))
        # instructions of the op per chain step: the difference of this
        # instantiation and the reps-16 one, so the address code drops out
        per_step = (sass[CHAIN_OPCODE[op]] - short[CHAIN_OPCODE[op]]) / (reps - 16)
        nbytes = 3 * a.numel() * a.element_size()
        case = {"kernel": kid, "op": op, "reps": reps, "max_abs_err": err,
                "max_rel_err": rel, "finite": finite, "gops": rate["gops"],
                "instr_per_step": per_step, "ginstr": rate["gops"] * per_step,
                "ms": rate["ms"], "ms_issued": probes.device_ms(
                    lambda: fn(op, a, b, reps), graph=False),
                "sass": dict(sass.most_common(4)),
                **bound(nbytes, pipe_ms(sass, a.numel()))}
        if (op, reps) == PROBE_ROW[kid]:
            case["plain_ms"] = probes.device_ms(
                lambda: probes.chain_plain(op, a, b, reps), 2, graph=False)
        out["cases"].append(case)
        log(f"[probe] {kid} {op:8s} reps={reps:4d} {rate['gops']:10.1f} G ops/s, "
            f"{per_step:.3f} {CHAIN_OPCODE[op]} per step ({rate['ms']:.4f} ms "
            f"graph, {case['ms_issued']:.4f} ms issued; bound "
            f"{case['bound_ms']:.4f} ms by {case['bound_by']}) max_abs_err={err} "
            f"max_rel={rel:.3g} SASS {case['sass']}")
        if not ok:
            raise AssertionError(f"{kid} {op} reps={reps} disagrees with its "
                                 "plain version")
    out["imad_per_s"] = max(c["gops"] for c in out["cases"]
                            if c["op"] == "mul") * 1e9
    log(f"[probe] P1 mul sustains {out['imad_per_s'] / 1e12:.3f} T IMAD/s, "
        f"{100 * out['imad_per_s'] / INT32_PER_S:.1f} % of the card's "
        f"{INT32_PER_S / 1e12:.2f} T/s that bounds B1-B6")
    report["probes"] = out
    return out


def random_limbs(gen, shape, device):
    """Canonical field elements (< 2^254 < p) as (16, *shape) int32."""
    import numpy as np
    import torch

    limbs = gen.integers(0, 1 << 16, size=(16,) + tuple(shape), dtype=np.int64)
    limbs[15] &= 0x3FFF
    return torch.as_tensor(limbs.astype(np.int32), device=device)


def max_abs_err(a, b) -> int:
    import torch

    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def record_row(out, kid, kernel, plain, reps, plain_reps, nbytes, ops,
               elements, plain_ms=None, pick=None, plain_lanes=None,
               tag="kernel"):
    """Holds kernel() against plain() on the card, times both, bounds the
    kernel and logs the row, which goes to out[kid].  ops: the SASS Counter
    that one of `elements` threads issues; plain_ms: the plain version's
    time where it was measured before; pick(got): the kernel's output on
    the `plain_lanes` lanes that a sampled plain() computes.  Kernel ms:
    CUDA graph replays; ms_issued: the same launches issued one by one from
    Python, which shows where the host held the kernel back."""
    import torch

    from tinyram_tpu_torch.probes import device_ms

    got = kernel()
    want = plain()
    sync()
    err = max_abs_err(got if pick is None else pick(got), want)
    del got, want
    ms = device_ms(kernel, reps)
    ms_issued = device_ms(kernel, reps, graph=False)
    if plain_ms is None:
        plain_ms = device_ms(plain, plain_reps, graph=False)
    b = bound(nbytes, pipe_ms(ops, elements))
    n_imad, n_alu = imad_count(ops) * elements, alu_count(ops) * elements
    out[kid] = {"max_abs_err": err, "ms": ms, "ms_issued": ms_issued,
                "plain_ms": plain_ms, "imad": n_imad, "alu": n_alu, **b}
    on = ""
    if plain_lanes is not None:
        out[kid]["plain_lanes"] = plain_lanes
        on = f" (on {plain_lanes})"
    log(f"[{tag}] {kid} max_abs_err={err} ms={ms:.4f} (issued "
        f"{ms_issued:.4f}) plain_ms={plain_ms:.4f}{on} bound_ms="
        f"{b['bound_ms']:.4f} ({b['bound_by']}: {nbytes / 1e6:.1f} MB, "
        f"{n_imad / 1e6:.1f} M IMAD, {n_alu / 1e6:.1f} M ALU)")
    torch.cuda.empty_cache()
    if err != 0:
        raise AssertionError(f"{kid} ({tag}) disagrees with its plain version")


def sass_tables(funcs, listing):
    """(each kernel's SASS opcode counts, one Montgomery product's SASS per
    point kernel, each staged kernel's SASS per lane with its product loops
    run out)."""
    sass = {kid: sass_of(funcs, part) for kid, part in SASS_NAME.items()}
    # the point kernels: one product's SASS and the number of product
    # loops; per lane (and step), the whole SASS with each loop run out
    product, per_lane = {}, {}
    for kid, products in STAGED.items():
        product[kid], loops = product_loop(sass_of(listing, SASS_NAME[kid]))
        per_lane[kid] = {
            op: sass[kid][op] + (products - loops) * product[kid].get(op, 0)
            for op in set(sass[kid]) | set(product[kid])}
        log(f"[sass] {kid}: {loops} product loops, per product IMAD "
            f"{imad_count(product[kid]):.0f} ALU {alu_count(product[kid]):.0f}; "
            f"per lane{' and step' if kid in ('B4s', 'B5l', 'B6') else ''} "
            f"IMAD {imad_count(per_lane[kid]):.0f} ALU "
            f"{alu_count(per_lane[kid]):.0f}")
    product["B3s"], per_lane["B3s"] = product["B3"], per_lane["B3"]
    product["B6h"] = product["B4"]
    return sass, product, per_lane


def projective_points(gen, srs, lanes, dev):
    """Two projective batches of `lanes` SRS points with random z and 5 %
    identity lanes, and the affine (x, y) of the first."""
    import torch

    from tinyram_tpu_torch.curve.vesta import PointBatch
    from tinyram_tpu_torch.field.field import FQ_PLAIN

    idx = torch.as_tensor(gen.integers(0, srs.n, size=lanes), device=dev)
    gx, gy = srs.g.x[:, idx], srs.g.y[:, idx]
    ident = torch.as_tensor(gen.random(lanes) < 0.05, device=dev)

    def projective(px, py):
        z = random_limbs(gen, (lanes,), dev)
        z[0] |= 1  # nonzero
        X, Y = FQ_PLAIN.mul(px, z), FQ_PLAIN.mul(py, z)
        zero = torch.zeros_like(z)
        one = FQ_PLAIN.ones((lanes,), dev)
        return PointBatch(FQ_PLAIN.select(ident, zero, X),
                          FQ_PLAIN.select(ident, one, Y),
                          FQ_PLAIN.select(ident, zero, z))

    return (projective(gx, gy), projective(gx.roll(7, 1), gy.roll(7, 1)),
            gx, gy)


def check_kernels(dev, gen, srs, tables) -> dict:
    """B1-B6, B3s, B4s, B5l and B6h against their plain versions at the main
    path's shapes, with the bytes and the integer instructions each call needs (by
    pipe, from the SASS).  Kernel ms: CUDA graph replays; ms_issued: the
    same launches issued one by one from Python, which shows where the host
    held the kernel back."""
    import torch

    import torch_point_sweep as sweep
    from tinyram_tpu_torch.curve import cuda_point as cp
    from tinyram_tpu_torch.curve import vesta
    from tinyram_tpu_torch.curve.vesta import PointBatch
    from tinyram_tpu_torch.field.cuda_mul import mont_mul, mont_mul_plain
    from tinyram_tpu_torch.field.field import FP, FP_PLAIN
    from tinyram_tpu_torch.poly import cuda_ntt
    from tinyram_tpu_torch.poly.ntt import radix2_stages
    from tinyram_tpu_torch.probes import device_ms

    out = {}
    sass, product, per_lane = tables

    record = functools.partial(record_row, out)

    # B1 at (16, 2^18): one of the main path's wide elementwise products
    n = 1 << 18
    a = random_limbs(gen, (n,), dev)
    b = random_limbs(gen, (n,), dev)
    record("B1", lambda: mont_mul(a, b, FP.params),
           lambda: mont_mul_plain(a, b, FP.params), 50, 5,
           3 * FE_BYTES * n, sass["B1"], n)

    # B2 at the first level of a 64-column 2^14 lagrange->coeff: rows of
    # 128 points with the cross twiddles as output multiplier.  Each row
    # does S/2 butterflies per stage and S output products, each counted
    # as one Montgomery product of B1's SASS.
    rows, log_s = 64 * 128, 7
    x = random_limbs(gen, (rows, 1 << log_s), dev)
    cross = torch.as_tensor(
        cuda_ntt._cross_twiddles_host("Fp", 7, 7, True), device=dev)
    products = rows * ((1 << log_s) // 2 * log_s + (1 << log_s))
    record("B2", lambda: cuda_ntt.colntt(x, FP, True, cross, None),
           lambda: cuda_ntt.colntt_plain(x, FP, True, cross, None), 20, 2,
           2 * FE_BYTES * x[0].numel() + FE_BYTES * (1 << log_s) // 2
           + cross.numel() * cross.element_size(), sass["B1"], products)
    # and a whole batched transform, 16 x 2^17, through the four-step split
    xb = random_limbs(gen, (16, 1 << 17), dev)
    got = cuda_ntt.ntt_cuda(FP, xb)
    want = radix2_stages(FP_PLAIN, xb, False)
    sync()
    err = max_abs_err(got, want)
    log(f"[kernel] B2 four-step 16x2^17 max_abs_err={err}")
    if err:
        raise AssertionError("four-step NTT disagrees with the plain NTT")

    # B3-B6 at 2^15 lanes: SRS points, random projective scaling, and
    # identity lanes mixed in.  B3 and B5 add only where the mask is set:
    # their accumulator is read and their products run on those lanes.
    lanes = 1 << 15
    p, q, gx, gy = projective_points(gen, srs, lanes, dev)
    mask = torch.as_tensor(gen.random(lanes) < 0.5, device=dev)
    m = int(mask.sum())
    pt = 3 * FE_BYTES
    record("B3", lambda: tuple(cp.padd_select_mixed(mask, p, gx, gy)),
           lambda: tuple(cp.madd_select_plain(mask, p, gx, gy)), 50, 3,
           lanes + 2 * FE_BYTES * lanes + pt * m + pt * lanes, product["B3"],
           MADD * m)
    # B4 at 2^15 lanes: the carry fixup's width (G = 256 windows of 128
    # chunk lanes at 64 MSM columns); and at 1280, the width of the final
    # adds (20 windows of 64 columns)
    record("B4", lambda: tuple(cp.padd(p, q)),
           lambda: tuple(cp.padd_plain(p, q)), 50, 3,
           3 * pt * lanes, product["B4"], ADD * lanes)
    record("B5", lambda: tuple(cp.padd_select(mask, p, q)),
           lambda: tuple(cp.padd_select_plain(mask, p, q)), 50, 3,
           lanes + pt * lanes + pt * m + pt * lanes, product["B5"], ADD * m)
    cols = 20 * 64
    p_w, q_w = (PointBatch(*(c[:, :cols].contiguous() for c in x))
                for x in (p, q))
    record("B4@1280", lambda: tuple(cp.padd(p_w, q_w)),
           lambda: tuple(cp.padd_plain(p_w, q_w)), 50, 3,
           3 * pt * cols, product["B4"], ADD * cols)
    # B6: one doubling at 2^15 lanes (the earlier table's shape), and the
    # longer of the weighted reduce's doubling chains (c - 1 = 12 at 1280)
    record("B6@2^15", lambda: tuple(cp.pdouble(p)),
           lambda: tuple(cp.pdouble_plain(p)), 50, 3,
           2 * pt * lanes, product["B6"], DBL * lanes)
    record("B6", lambda: tuple(cp.pdouble(p_w, times=12)),
           lambda: tuple(cp.pdouble_plain(p_w, 12)), 20, 2,
           2 * pt * cols, product["B6"], 12 * DBL * cols)

    # B3s and B5l at config 2's shapes: the bucket scan of one group (L =
    # 128 steps at 2^15 lanes, `same` from sorted random c = 13 digits) and
    # one IPA round's ladder (R = 256 bits at 2^15 lanes), each beside the
    # Python loop of one-step launches it replaces.
    L, R = 128, 256
    same = sweep.bucket_same(gen, L, lanes, device=dev)
    pick = torch.as_tensor(gen.integers(0, srs.n, size=L * lanes), device=dev)
    sx, sy = (c[:, pick].reshape(16, L, lanes).transpose(0, 1).contiguous()
              for c in (srs.g.x, srs.g.y))
    bits = torch.as_tensor(gen.random((R, lanes)) < 0.5, device=dev)
    n_same, n_bits = int(same.sum()), int(bits.sum())
    ident = vesta.identity((lanes,), dev)
    record("B3s", lambda: tuple(cp.padd_select_mixed_scan(same, sx, sy)),
           lambda: tuple(cp.madd_select_scan_plain(same, sx, sy)), 2, 1,
           L * lanes + 2 * FE_BYTES * L * lanes + 3 * FE_BYTES * L * lanes,
           product["B3s"], MADD * n_same)
    record("B5l", lambda: tuple(cp.padd_select_ladder(bits, p)),
           lambda: tuple(cp.ladder_plain(bits, p)), 2, 1,
           R * lanes + 2 * pt * lanes, product["B5l"],
           DBL * R * lanes + ADD * n_bits)
    for kid, loop in (
            ("B3s", lambda: sweep.scan_loop(cp, same, sx, sy, ident)),
            ("B5l", lambda: sweep.ladder_loop(cp, bits, p, ident))):
        c = out[kid]
        c["loop_ms"] = device_ms(loop, 1)
        c["loop_ms_issued"] = device_ms(loop, 1, graph=False)
        log(f"[kernel] {kid} one launch {c['ms']:.4f} ms graph, "
            f"{c['ms_issued']:.4f} ms issued; the loop of one-step launches "
            f"it replaces {c['loop_ms']:.4f} ms graph, "
            f"{c['loop_ms_issued']:.4f} ms issued")
    out["B3s"]["same_share"] = n_same / (L * lanes)
    out["B5l"]["bit_share"] = n_bits / (R * lanes)
    del sx, sy, same

    # B4s at config 2's shape: the suffix scan of 64 MSM columns (20
    # windows x H = 64 lanes each, S = 64 steps of two adds); B6h at 64 and
    # 4 columns (20 windows of c = 13)
    S, n_s = 64, cols * 64
    pick = torch.as_tensor(gen.integers(0, lanes, size=cols * (64 * S + 2)),
                           device=dev)  # 4098 buckets per window, as in msm.py
    b = PointBatch(*(c[:, pick].reshape(16, cols, 64 * S + 2)[..., :64 * S]
                     .reshape(16, cols, 64, S) for c in p))
    record("B4s", lambda: tuple(x for acc_tot in cp.padd_suffix_scan(b)
                                for x in acc_tot),
           lambda: tuple(x for acc_tot in cp.suffix_scan_plain(b)
                         for x in acc_tot), 2, 1,
           3 * FE_BYTES * S * n_s + 6 * FE_BYTES * n_s, product["B4s"],
           (2 * S - 1) * ADD * n_s)
    nw, c_bits = 20, 13
    horner_products = nw * (c_bits * DBL + ADD)
    for n_cols, tag in ((64, ""), (4, "@4")):
        ws = PointBatch(*(c[:, :nw * n_cols].reshape(16, nw, n_cols) for c in p))
        want = tuple(cp.horner_plain(ws, c_bits))
        plain_ms = device_ms(lambda: cp.horner_plain(ws, c_bits), 1,
                             graph=False)
        for group, kid in ((4, "B6h" + tag), (1, "B6h G=1" + tag)):
            record(kid, lambda: tuple(cp.pdouble_horner(ws, c_bits, group)),
                   lambda: want, 3, 1, pt * nw * n_cols + pt * n_cols,
                   product["B6h"], horner_products * n_cols, plain_ms)
    # one lane, one thread: its products run one after another, so the
    # time over their count is one product's latency at one warp (the
    # additions between them included); the chain bound is the formulas'
    # depth in products (2 per doubling, 2 per add) at that latency
    one = PointBatch(*(c[:, :nw].reshape(16, nw, 1) for c in p))
    latency_ms = device_ms(lambda: cp.pdouble_horner(one, c_bits, 1), 3) \
        / horner_products
    out["B6h"]["product_latency_us"] = latency_ms * 1e3
    out["B6h"]["chain_ms"] = nw * (2 * c_bits + 2) * latency_ms
    log(f"[kernel] B6h one product's latency {latency_ms * 1e3:.4f} us at "
        f"one warp; chain bound {out['B6h']['chain_ms']:.4f} ms "
        f"({nw * (2 * c_bits + 2)} dependent products)")

    ident_s = vesta.identity((cols, 64), dev)
    take = torch.ones((cols, 64), dtype=torch.bool, device=dev)
    ws = PointBatch(*(c[:, :nw * 64].reshape(16, nw, 64) for c in p))
    ident_h = vesta.identity((64,), dev)
    for kid, loop in (
            ("B4s", lambda: sweep.suffix_loop(cp, b, ident_s, take)),
            ("B6h", lambda: sweep.horner_loop(cp, ws, c_bits, ident_h)),
            ("B6", lambda: sweep.doubling_loop(cp, p_w, 12))):
        c = out[kid]
        c["loop_ms"] = device_ms(loop, 1)
        c["loop_ms_issued"] = device_ms(loop, 1, graph=False)
        log(f"[kernel] {kid} one launch {c['ms']:.4f} ms graph, "
            f"{c['ms_issued']:.4f} ms issued; the loop of one-step launches "
            f"it replaces {c['loop_ms']:.4f} ms graph, "
            f"{c['loop_ms_issued']:.4f} ms issued")
    out["sweep"] = sweep.sweep(dev, cp, device_ms)
    out["imad_per_element"] = {k: imad_count(c) for k, c in sass.items()}
    out["alu_per_element"] = {k: alu_count(c) for k, c in sass.items()}
    out["staged"] = {k: {"per_product_imad": imad_count(product[k]),
                         "per_product_alu": alu_count(product[k]),
                         "per_lane_imad": imad_count(per_lane[k]),
                         "per_lane_alu": alu_count(per_lane[k])}
                     for k in per_lane}
    return out


def device_limbs(gen, shape, dev):
    """random_limbs made on the card from a seed drawn from `gen` (the
    config-3 operands are GBs: too many for numpy on the host)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(int(gen.integers(1 << 62)))
    t = torch.randint(0, 1 << 16, (16,) + tuple(shape), generator=g,
                      device=dev, dtype=torch.int32)
    t[15] &= 0x3FFF
    return t


def sample(gen, n, k, dev):
    """k sorted distinct indices below n, as a tensor on `dev`."""
    import torch

    idx = gen.choice(n, size=min(k, n), replace=False)
    return torch.as_tensor(sorted(idx), device=dev)


def check_config3_kernels(dev, gen, srs, tables, b1_lanes: int) -> dict:
    """B1-B6 and the loop forms at config 3's shapes: the widest B1 launch
    of the config-3 proof, B2's two levels of a 64-column coset lift at
    2^19, and the 64-column commit pass of 2^17 points at c = 16 (B3s over
    the plan's 128 steps at 2^15 lanes, B4s over 1024 windows of 256 lanes
    and 128 steps, B6h over 16 windows of 16 doublings, the doubling chains
    of 7 and 15, B4 at the suffix doubling's 2^18 lanes and the carry
    fixup's B4 and B5 at 2^15).  Each runs at full width on the card and is
    held against its plain version on every lane, or, where the plain
    version would take minutes, on a seeded sample of independent lanes,
    rows or windows (`plain_lanes` says how many)."""
    import torch

    import torch_point_sweep as sweep
    from tinyram_tpu_torch.curve import cuda_point as cp
    from tinyram_tpu_torch.curve.vesta import PointBatch
    from tinyram_tpu_torch.field.cuda_mul import mont_mul, mont_mul_plain
    from tinyram_tpu_torch.field.field import FP
    from tinyram_tpu_torch.poly import cuda_ntt

    sass, product, _ = tables
    out = {}
    record = functools.partial(record_row, out, tag="config3 kernel")

    # B1 at the widest launch of the config-3 proof
    n = b1_lanes
    a, b = device_limbs(gen, (n,), dev), device_limbs(gen, (n,), dev)
    idx = sample(gen, n, 1 << 16, dev)
    record("B1", lambda: mont_mul(a, b, FP.params),
           lambda: mont_mul_plain(a[:, idx], b[:, idx], FP.params), 5, 1,
           3 * FE_BYTES * n, sass["B1"], n, pick=lambda t: t[:, idx],
           plain_lanes=len(idx))
    del a, b

    # B2: the two levels of a 64-column lift to 2^19 points (a = 2^10, b =
    # 2^9): rows of 1024 with the cross multipliers, then rows of 512
    for log_s, rows, mult in (
            (10, 64 << 9, torch.as_tensor(cuda_ntt._cross_twiddles_host(
                "Fp", 10, 9, False), device=dev)),
            (9, 64 << 10, None)):
        S = 1 << log_s
        x = device_limbs(gen, (rows, S), dev)
        idx = sample(gen, rows, 128, dev)
        m_idx = None if mult is None else mult[:, idx % mult.shape[1]]
        record(f"B2 rows {S}",
               lambda: cuda_ntt.colntt(x, FP, False, mult, None),
               lambda: cuda_ntt.colntt_plain(x[:, idx], FP, False, m_idx),
               5, 1, 2 * FE_BYTES * rows * S + FE_BYTES * S // 2
               + (0 if mult is None else FE_BYTES * mult[0].numel()),
               sass["B1"], rows * (S // 2 * log_s + (S if mult is not None else 0)),
               pick=lambda t: t[:, idx], plain_lanes=len(idx))
        del x

    # B3s: the bucket scan of one group of the 64-column pass (plan: 32
    # windows of 1024 chunk lanes, L = 128), `same` from sorted c = 16 digits
    L, lanes = 128, 1 << 15
    same = sweep.bucket_same(gen, L, lanes, lanes_per_window=1024, c=16,
                             device=dev)
    pick = torch.as_tensor(gen.integers(0, srs.n, size=L * lanes), device=dev)
    sx, sy = (c[:, pick].reshape(16, L, lanes).transpose(0, 1).contiguous()
              for c in (srs.g.x, srs.g.y))
    n_same = int(same.sum())
    record("B3s", lambda: tuple(cp.padd_select_mixed_scan(same, sx, sy)),
           lambda: tuple(cp.madd_select_scan_plain(same, sx, sy)), 2, 1,
           L * lanes + 2 * FE_BYTES * L * lanes + 3 * FE_BYTES * L * lanes,
           product["B3s"], MADD * n_same, plain_lanes=lanes)
    out["B3s"]["same_share"] = n_same / (L * lanes)
    del same, sx, sy, pick

    # B4s: 1024 windows (64 columns x 16) of H = 256 lanes and S = 128
    # steps, read through the msm's strided view (2^15 + 2 buckets a window)
    p, q, _, _ = projective_points(gen, srs, lanes, dev)
    windows, H, S = 1024, 256, 128
    n_s = windows * H
    pick = torch.as_tensor(gen.integers(0, lanes, size=windows * (H * S + 2)),
                           device=dev)
    bk = PointBatch(*(c[:, pick].reshape(16, windows, H * S + 2)[..., :H * S]
                      .reshape(16, windows, H, S) for c in p))
    del pick
    w_idx = sample(gen, windows, 32, dev)
    record("B4s", lambda: tuple(x for part in cp.padd_suffix_scan(bk)
                                for x in part),
           lambda: tuple(x for part in cp.suffix_scan_plain(
               PointBatch(*(c[:, w_idx] for c in bk))) for x in part),
           1, 1, 3 * FE_BYTES * S * n_s + 6 * FE_BYTES * n_s, product["B4s"],
           (2 * S - 1) * ADD * n_s, pick=lambda t: tuple(x[:, w_idx] for x in t),
           plain_lanes=len(w_idx) * H)
    del bk

    # B6h (16 windows of c = 16 over 64 columns) and the doubling chains
    # (15 for the top bucket, 7 for the weighted sum, at 64 x 16 lanes)
    nw, c_bits, cols = 16, 16, 64
    ws = PointBatch(*(c[:, :nw * cols].reshape(16, nw, cols) for c in p))
    record("B6h", lambda: tuple(cp.pdouble_horner(ws, c_bits)),
           lambda: tuple(cp.horner_plain(ws, c_bits)), 3, 1,
           3 * FE_BYTES * nw * cols + 3 * FE_BYTES * cols, product["B6h"],
           nw * (c_bits * DBL + ADD) * cols, plain_lanes=cols)
    p_w = PointBatch(*(c[:, :nw * cols].contiguous() for c in p))
    for times in (15, 7):
        record(f"B6 x{times}", lambda: tuple(cp.pdouble(p_w, times=times)),
               lambda: tuple(cp.pdouble_plain(p_w, times)), 5, 1,
               6 * FE_BYTES * nw * cols, product["B6"],
               times * DBL * nw * cols, plain_lanes=nw * cols)

    # B4 at the suffix doubling's first level (1024 windows x 256 lanes),
    # and the carry fixup's B4 and B5 at 2^15 lanes
    p18, q18, _, _ = projective_points(gen, srs, n_s, dev)
    record("B4@2^18", lambda: tuple(cp.padd(p18, q18)),
           lambda: tuple(cp.padd_plain(p18, q18)), 5, 1, 9 * FE_BYTES * n_s,
           product["B4"], ADD * n_s, plain_lanes=n_s)
    del p18, q18
    mask = torch.as_tensor(gen.random(lanes) < 0.5, device=dev)
    m = int(mask.sum())
    record("B4", lambda: tuple(cp.padd(p, q)),
           lambda: tuple(cp.padd_plain(p, q)), 20, 1, 9 * FE_BYTES * lanes,
           product["B4"], ADD * lanes, plain_lanes=lanes)
    record("B5", lambda: tuple(cp.padd_select(mask, p, q)),
           lambda: tuple(cp.padd_select_plain(mask, p, q)), 20, 1,
           lanes + 3 * FE_BYTES * (2 * lanes + m), product["B5"], ADD * m,
           plain_lanes=lanes)
    return out


def config3_phase(dev, report) -> dict:
    """BASELINE config 3 (2^16 steps, W=24, k=17, the full ISA with memory)
    through `tinyram.prove_config.prove_config(3)`, the function behind
    scripts/torch_prove_config3.py --mock --prove: the Python and native
    traces equal, the mock without failure, the proof verifies and answer
    + 1 is rejected (the function raises otherwise).  The launch counts are
    set to 0 just before the proof and read just after it; every kernel of
    the config-3 path must have launched.  The proof's widest B1 launch is
    the shape at which B1 is then checked."""
    import torch

    from tinyram_tpu_torch.tinyram.prove_config import prove_config

    rep = prove_config(3, device=dev, cache_dir=None, rng=SeededRng(SEED),
                        log=log)
    objects = rep.pop("objects")
    launches = rep["launches"]
    missing = [k for k in CONFIG3_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the config-3 proof: "
                             f"{missing}")
    if launches["B3"] or launches["B4s"] != launches["B6h"] \
            or launches["B6"] > 2 * launches["B6h"]:
        raise AssertionError("the config-3 proof ran one-step loops: "
                             f"{launches}")
    rep["peak_bytes_max"] = max(rep["peak_bytes"].values())
    log(f"[config3] seconds {rep['seconds']}; phases {rep['phases']}; "
        f"verifier phases {rep['verifier_phases']}; launches per proof "
        f"{launches}; peak device memory {rep['peak_bytes_max'] / 2**30:.2f} "
        f"GiB; widest B1 launch {rep['widest_launches']['B1']} elements")
    report["config3"] = rep
    srs = objects["srs"]
    del objects
    torch.cuda.empty_cache()
    return srs


def prove_config(dev, report) -> dict:
    """The main path at BASELINE config 2."""
    from tinyram_tpu_torch import kernels
    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.plonk import create_proof
    from tinyram_tpu_torch.tinyram import TinyRamCircuit, eval_program
    from tinyram_tpu_torch.tinyram.bench_programs import config2_program
    from tinyram_tpu_torch.utils.profiling import counters

    W, R = 24, 8
    t = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        sync()
        t[name] = time.time() - t0
        log(f"[main] {name}: {t[name]:.2f}s")
        return out

    prog = config2_program(1 << 12, word_bits=W)
    trace = timed("emulate", lambda: eval_program(prog, W, R))
    circ = TinyRamCircuit(W, R)
    log(f"[main] W={W} k={circ.k} steps={len(trace)} "
        f"advice={circ.tcs.cs.num_advice}")
    srs = timed("srs setup (cached when k=14)", lambda: setup(circ.k, dev))
    pk = timed("keygen", lambda: circ.keygen(srs))
    asg = timed("witness", lambda: circ.assignment(trace, dev))
    kernels.reset_launch_counts()
    counters.ops.clear()
    counters.seconds.clear()
    proof = timed("prove", lambda: create_proof(
        srs, pk, asg, rng=SeededRng(SEED),
        phase_hook=lambda name, s, n: log(f"[phase] {name}: {s:.3f}s, "
                                          f"{n} kernel launches")))
    launches = kernels.launch_counts()
    phases = {k: v for k, v in counters.report().items()
              if k.startswith("prover.")}
    log(f"[main] launches during the proof: {launches}")
    missing = [k for k in PROOF_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the proof: {missing}")
    if launches["B3"]:
        raise AssertionError("the proof launched the one-step B3, not B3s")
    # one B4s and one B6h per Pippenger MSM, and B6 only for its two
    # doubling chains: the Horner and the suffix scan ran no one-step steps
    if launches["B4s"] != launches["B6h"] or launches["B6"] > 2 * launches["B6h"]:
        raise AssertionError("the window combine or the suffix scan ran "
                             f"one-step launches: {launches}")
    ok = timed("verify", lambda: circ.verify(srs, pk, prog, trace.answer, proof))
    ok_warm = timed("verify warm", lambda: circ.verify(
        srs, pk, prog, trace.answer, proof))
    bad = timed("verify answer+1", lambda: circ.verify(
        srs, pk, prog, trace.answer + 1, proof))
    verifier = {k: v["seconds"] for k, v in counters.report().items()
                if k.startswith("verifier.")}
    log(f"[main] proof {len(proof)} bytes, verify={ok}, warm={ok_warm}, "
        f"answer+1 accepted={bad}; verifier phases {verifier}")
    if not (ok and ok_warm) or bad:
        raise AssertionError("config proof failed verification checks")
    report["main"] = {"word_bits": W, "k": circ.k, "steps": len(trace),
                      "seconds": t, "phases": phases, "launches": launches,
                      "verifier_phases": verifier, "proof_bytes": len(proof)}
    return {"circ": circ, "prog": prog, "trace": trace, "srs": srs, "pk": pk,
            "proof": proof, "launches": launches}


def mock_phase(dev, report, cfg) -> None:
    """The mock prover on the config-2 trace: clean, then one forged
    advice cell."""
    import numpy as np
    import torch

    from tinyram_tpu_torch import kernels
    from tinyram_tpu_torch.field import FP
    from tinyram_tpu_torch.plonk import MockProver

    circ, trace = cfg["circ"], cfg["trace"]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.time()
    clean = circ.mock_prove(trace, device=dev)
    sync()
    seconds = time.time() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[mock] config 2 clean: {len(clean)} failures, {seconds:.2f}s, "
        f"peak device memory {peak} B, launches {launches}")
    if clean:
        raise AssertionError(f"mock failures on the clean trace: {clean[:5]}")
    if launches["B1"] == 0:
        raise AssertionError("B1 never launched by the mock")

    family, column = MOCK_FORGE
    asg = circ.assignment(trace, dev)
    row = FP.decode(asg.get(circ.tcs.col.advice[f"out.{family}"])).index(1)
    col = circ.tcs.col.advice[column]
    vals = FP.decode(asg.get(col))
    vals[row] = (vals[row] + 1) % FP.modulus
    asg.set(col, np.array(vals, dtype=object))
    t0 = time.time()
    forged = MockProver(circ.tcs.cs, asg).verify()
    forged_s = time.time() - t0
    log(f"[mock] config 2, {column} + 1 on row {row}: {forged_s:.2f}s, "
        f"{[str(f) for f in forged]}")
    if not naming(forged, family):
        raise AssertionError(f"forged {column} not reported by the {family} gate")
    report["mock"] = {"seconds": seconds, "forged_seconds": forged_s,
                      "peak_bytes": peak, "launches": launches,
                      "forged": [str(f) for f in forged]}


def negative_phase(dev, report) -> None:
    """The 13 forged W=8 families: named by the mock, rejected by the
    verifier; the clean proof accepted.  One SRS and one pk."""
    from tinyram_tpu_torch import kernels
    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.plonk import MockProver, create_proof
    from tinyram_tpu_torch.tinyram import (Imm, Instruction, Reg,
                                           TinyRamCircuit, eval_program)

    circ = TinyRamCircuit(8, 8)
    prog = [Instruction("Mov", 2, None, Imm(55)),
            Instruction("Shr", 3, 2, Imm(2)),
            Instruction("Answer", None, None, Reg(3))]
    tr = eval_program(prog, 8, 8)
    t0 = time.time()
    srs = setup(circ.k, dev)
    pk = circ.keygen(srs)
    kernels.reset_launch_counts()
    proof = create_proof(srs, pk, circ.assignment(tr, dev))
    if not circ.verify(srs, pk, prog, tr.answer, proof):
        raise AssertionError("the clean W=8 proof is rejected")
    per = {}
    for family, payload in FAMILY_PAYLOADS:
        t1 = time.time()
        asg = forged_assignment(circ, tr, family, payload, dev)
        fails = MockProver(circ.tcs.cs, asg).verify()
        named = naming(fails, family)
        if not named:
            raise AssertionError(f"mock does not name {family}: "
                                 f"{[f.name for f in fails]}")
        proof = create_proof(srs, pk, asg)
        if circ.verify(srs, pk, prog, tr.answer, proof):
            raise AssertionError(f"forged {family} witness produced a "
                                 "verifying proof")
        per[family] = time.time() - t1
        log(f"[negative] {family}: mock names it ({named[0]}), proof "
            f"rejected, {per[family]:.2f}s")
    seconds = time.time() - t0
    launches = kernels.launch_counts()
    log(f"[negative] 13 families + clean: {seconds:.2f}s, launches {launches}")
    report["negative"] = {"seconds": seconds, "per_family": per,
                          "launches": launches}


def w16_phase(dev, report) -> None:
    """W=16, k=10: tests/test_tinyram_proof.py::test_proof_w16's program."""
    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.tinyram import (Imm, Instruction, Reg,
                                           TinyRamCircuit, eval_program)

    circ = TinyRamCircuit(16, 8)
    prog = [Instruction("Mov", 0, None, Imm(0xBEEF)),
            Instruction("Mull", 1, 0, Imm(0x123)),
            Instruction("Shr", 2, 1, Imm(5)),
            Instruction("Cmpg", 2, None, Imm(0x7FFF)),
            Instruction("CMov", 3, None, Imm(77)),
            Instruction("Answer", None, None, Reg(2))]
    tr = eval_program(prog, 16, 8)
    t0 = time.time()
    srs = setup(circ.k, dev)
    pk = circ.keygen(srs)
    proof = circ.prove(srs, pk, tr)
    prove_s = time.time() - t0
    ok = circ.verify(srs, pk, prog, tr.answer, proof)
    bad = circ.verify(srs, pk, prog, tr.answer + 1, proof)
    log(f"[w16] k={circ.k}: set-up + prove {prove_s:.2f}s, verify={ok}, "
        f"answer+1 accepted={bad}")
    if not ok or bad:
        raise AssertionError("W=16 proof failed verification checks")
    report["w16"] = {"k": circ.k, "prove_s": prove_s}


def batch_phase(dev, report, cfg) -> None:
    from tinyram_tpu_torch.plonk import BatchVerifier

    circ, srs, vk = cfg["circ"], cfg["srs"], cfg["pk"].vk
    prog, answer, proof = cfg["prog"], cfg["trace"].answer, cfg["proof"]
    good = circ.instance_arrays(prog, answer)
    wrong = circ.instance_arrays(prog, answer + 1)
    t0 = time.time()
    bv = BatchVerifier()
    bv.add_proof(good, proof)
    bv.add_proof(good, proof)
    both = bv.finalize(srs, vk, rng=SeededRng(SEED))
    bv = BatchVerifier()
    bv.add_proof(good, proof)
    bv.add_proof(wrong, proof)
    mixed = bv.finalize(srs, vk, rng=SeededRng(SEED))
    detailed = bv.finalize_detailed(srs, vk)
    seconds = time.time() - t0
    log(f"[batch] two good: {both}, good + answer+1: {mixed}, "
        f"per proof {detailed}, {seconds:.2f}s")
    if not both or mixed or detailed != [True, False]:
        raise AssertionError("batch verifier gave a wrong verdict")
    report["batch"] = {"seconds": seconds}


def keyfile_phase(dev, report, cfg) -> None:
    """save_pk / load_pk of the config-2 key: equal proof bytes."""
    from tinyram_tpu_torch.plonk import create_proof, load_pk, save_pk

    circ, srs, pk, trace = cfg["circ"], cfg["srs"], cfg["pk"], cfg["trace"]
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "config2_pk.npz")
    t0 = time.time()
    save_pk(path, pk)
    save_s = time.time() - t0
    size = os.path.getsize(path)
    t0 = time.time()
    loaded = load_pk(path, circ.tcs.cs, dev)
    load_s = time.time() - t0
    proof = create_proof(srs, loaded, circ.assignment(trace, dev),
                         rng=SeededRng(SEED))
    same = proof == cfg["proof"]
    log(f"[keyfile] {size} B saved in {save_s:.2f}s, loaded in {load_s:.2f}s, "
        f"proof bytes equal: {same}")
    if not same:
        raise AssertionError("the reloaded pk proves other bytes")
    report["keyfile"] = {"bytes": size, "save_s": save_s, "load_s": load_s}


def golden_check(dev, report) -> None:
    """W=8 Answer-only proof on the card == the JAX package's bytes."""
    import numpy as np

    from tinyram_tpu_torch.convert import pk_from_numpy, points_from_bytes
    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.tinyram import Imm, Instruction, TinyRamCircuit
    from tinyram_tpu_torch.tinyram import eval_program

    rec = np.load(os.path.join(ROOT, "tests", "data", "torch_golden_w8.npz"))
    circ = TinyRamCircuit(8, 8)
    srs = setup(circ.k, dev)
    arrays = dict(rec)
    arrays["fixed_commitments"] = points_from_bytes(
        rec["fixed_comm"], rec["fixed_comm_none"])
    pk = pk_from_numpy(arrays, circ.tcs.cs, dev)
    prog = [Instruction("Answer", None, None, Imm(0))]
    t0 = time.time()
    proof = circ.prove(srs, pk, eval_program(prog, 8, 8), rng=SeededRng(1))
    dt = time.time() - t0
    same = proof == rec["proof_answer"].tobytes()
    ok = circ.verify(srs, pk, prog, 0, proof)
    log(f"[golden] W=8 proof {dt:.1f}s, equal to the JAX bytes: {same}, "
        f"verifies: {ok}")
    report["golden_w8"] = {"prove_s": dt, "equal": same, "verifies": ok}
    if not (same and ok):
        raise AssertionError("W=8 proof differs from the JAX package's")


def entry_phase(dev, report) -> None:
    """`tinyram_tpu_torch.entry.entry()` (NTT -> multiply -> inverse NTT
    at 2^12, the twin of `__graft_entry__.entry()`) on the card, equal bit
    for bit to the same function on the CPU (B1's and B2's plain versions);
    B1 and B2 must launch on the card."""
    import torch

    from tinyram_tpu_torch import kernels
    from tinyram_tpu_torch.entry import entry

    t0 = time.time()
    fn, args = entry()
    kernels.reset_launch_counts()
    got = fn(*args)
    sync()
    launches = kernels.launch_counts()
    fn_cpu, args_cpu = entry(torch.device("cpu"))
    want = fn_cpu(*args_cpu)
    same = torch.equal(got.cpu(), want)
    seconds = time.time() - t0
    log(f"[entry] 2^12 NTT -> mul -> inverse NTT: card equal to CPU: {same}, "
        f"launches B1={launches['B1']} B2={launches['B2']}, {seconds:.2f}s")
    report["entry"] = {"equal": same, "launches": launches, "seconds": seconds}
    if not same:
        raise AssertionError("entry() on the card differs from the CPU")
    if not (launches["B1"] and launches["B2"]):
        raise AssertionError(f"entry() did not run B1 and B2: {launches}")


def verify_msm_phase(dev, report) -> None:
    """`tinyram_tpu_torch.verify_msm` at 2^16 (c = 15, every case against
    the host oracle) and at 2^20 (c = 16; all-equal and selector-like
    against the oracle, random and edge against the sum of the halves'
    MSMs at c = 13), with `setup(20)` timed on its own between them; the
    counts are reset before each run and every MSM kernel must launch."""
    from tinyram_tpu_torch import kernels, verify_msm
    from tinyram_tpu_torch.ipa.srs import CACHE_DIR, setup

    out = {}
    for log_n in (16, 20):
        if log_n == 20:
            t0 = time.time()
            setup(20, dev, cache_dir=CACHE_DIR)
            out["setup20_s"] = time.time() - t0
            log(f"[verify_msm] setup(20): {out['setup20_s']:.2f}s")
        kernels.reset_launch_counts()
        t0 = time.time()
        rep = verify_msm.run(log_n, dev, log=lambda m: log(f"[verify_msm] {m}"))
        rep["seconds"] = time.time() - t0
        rep["launches"] = kernels.launch_counts()
        out[f"2^{log_n}"] = rep
        log(f"[verify_msm] 2^{log_n}: {rep['seconds']:.2f}s, launches "
            f"{rep['launches']}")
        if not rep["ok"]:
            raise AssertionError(f"verify_msm at 2^{log_n} found mismatches")
        missing = [k for k in MSM_KERNELS if rep["launches"][k] == 0]
        if missing:
            raise AssertionError(f"verify_msm at 2^{log_n} never launched "
                                 f"{missing}")
    report["verify_msm"] = out


def bench_phase(dev, report, smi: str) -> None:
    """The throughput steps of `python -m tinyram_tpu_torch.bench` (MSM at
    2^16 and 2^20, modmul at 2^18, NTT at 2^20 and 16 x 2^18; its prove
    steps run in the bench's own run), with the counts reset before them:
    every kernel of those paths must launch.  Prints the bench's line."""
    from tinyram_tpu_torch import kernels
    from tinyram_tpu_torch.bench import Bench

    bench = Bench(dev, log=log)
    t0 = time.time()
    kernels.reset_launch_counts()
    bench.throughput()
    launches = kernels.launch_counts()
    seconds = time.time() - t0
    line = bench.line(smi)
    log(f"[bench] throughput steps {seconds:.2f}s")
    print(line, flush=True)
    report["bench"] = {"seconds": seconds, "results": bench.results,
                       "errors": bench.errors, "line": line}
    if bench.errors:
        raise AssertionError(f"bench steps failed: {bench.errors}")
    missing = [k for k in BENCH_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the bench steps never launched {missing}")
    if len(line) >= 1500:
        raise AssertionError(f"the bench line has {len(line)} characters")


SHARD_NTT_LOG = 20  # (b): the sharded NTT of one (16, 2^20) column
SHARD_MSM_LOG = 18  # (c): the sharded MSM over setup(18)'s generators


def _rank_peaks(stats) -> list:
    return [round(s["peak_bytes"] / 2**30, 3) for s in stats]


def _summed(stats) -> dict:
    out = collections.Counter()
    for s in stats:
        out.update(s["launches"])
    return dict(out)


def _check_sharded_proof(d: int, proofs: list, proof2: bytes, counts: dict,
                         out: dict, pattern: dict) -> list:
    """(d) of `shard_phase` for the D = d ranks' `paths.config_proof`
    results: the checks, the launches summed over the ranks into
    `counts`, and per rank (returned and printed) its prove and phase
    seconds, its peak GiB and the peak at the end of each phase, and the
    collectives of every phase.  Each phase's all-gather must be exactly
    `pattern` (`paths.gather_pattern`): the coefficient stacks stay row
    blocks."""
    from tinyram_tpu_torch.shard.paths import gathered_by_phase

    name = f"shard config 2 proof D={d}"
    stats = [p["stats"] for p in proofs]
    counts[name] = _summed(stats)
    out["seconds"][name] = max(s["seconds"] for s in stats)
    out["peak_gib"][name] = _rank_peaks(stats)
    same_ranks = len({p["proof"] for p in proofs}) == 1
    same_single = proofs[0]["proof"] == proof2
    log(f"[shard] config 2 at D={d}: {len(proofs[0]['proof'])} bytes, equal "
        f"on every rank {same_ranks}, equal to phase 4's proof "
        f"{same_single}, verify {proofs[0]['verified']}, answer+1 rejected "
        f"{proofs[-1]['rejected']}; launches summed over the ranks "
        f"{counts[name]}; all-gather elements a rank per phase expected "
        f"{pattern}")
    per_rank = []
    for r, st in enumerate(stats):
        coll = st["phase_collectives"]
        per_rank.append({"prove_s": st["seconds"], "phases": st["phases"],
                         "peak_gib": round(st["peak_bytes"] / 2**30, 3),
                         "phase_peak_gib": st["phase_peak_gib"],
                         "collectives": coll,
                         "all_gather": st["collectives"].get("all_gather", 0)})
        log(f"[shard] config 2 D={d} rank {r}: prove {st['seconds']:.3f}s, "
            f"peak {st['peak_bytes'] / 2**30:.3f} GiB, phases "
            f"{ {k: round(v, 3) for k, v in st['phases'].items()} }, "
            f"peak GiB at each phase's end "
            f"{ {k: round(v, 3) for k, v in st['phase_peak_gib'].items()} }, "
            f"collectives {coll}")
    if not (same_ranks and same_single and proofs[0]["verified"]
            and proofs[-1]["rejected"]):
        raise AssertionError(f"{name}: failed its checks")
    missing = [k for k in SHARD_PROOF_KERNELS if counts[name][k] == 0]
    if missing:
        raise AssertionError(f"{name}: never launched {missing}")
    for r, pr in enumerate(per_rank):
        coll = pr["collectives"]
        got = gathered_by_phase(stats[r])
        if got != pattern or pr["all_gather"] != sum(pattern.values()) \
                or any("unsplit" in c for c in coll.values()):
            raise AssertionError(f"{name} rank {r}: a coefficient stack was "
                                 f"gathered: all-gather a phase {got}, "
                                 f"{pr['all_gather']} in all, expected "
                                 f"{pattern}")
    return per_rank


def shard_phase(dev, report, proof2: bytes) -> dict:
    """15. The sharded paths (`tinyram_tpu_torch/shard/`), every rank a
    process on the one card (gloo, collectives staged through host
    memory): (a) `dryrun_multichip(2)` and `(4)`; a rank made to raise must
    make `run_on_mesh` raise within its deadline; (b) `ntt_sharded` of a
    (16, 2^20) column at D = 2 and 4, forward and inverse, gathered, equal
    bit for bit to the single-device `ntt`; (c) `msm_sharded` over
    `setup(18)`'s 2^18 generators at D = 2 (2^17 per rank: the Pippenger
    path), equal in affine form to the single-device `msm`; (d) BASELINE
    config 2 proved by `create_proof(mesh=)` at D = 2 and at D = 4 under
    the seeded stream of phase 4: equal bytes on every rank and equal to
    phase 4's proof, accepted by `verify_proof`, rejected for answer + 1;
    every coefficient column stays as the rank's row block, so on every
    rank each phase's all-gather is exactly `paths.gather_pattern`'s (the
    commitments' MSM partials, none in "constraint ext eval", the
    quotient's coefficients, one sum a slot, the opened polynomial) and no
    transform goes unsplit; (e) `scaling_report` at D = 1, 2, 4 (NTT
    2^20, MSM 2^18).  Each path's launch counts are reset in every rank
    before it and summed over the ranks: B2 and B1 must launch in (b),
    every MSM kernel in (c), and B1, B3s, B4, B4s, B5, B5l and B6h in (d).
    Returns the per-path counts."""
    import numpy as np
    import torch

    from tinyram_tpu_torch.curve import PointBatch, msm, to_affine_host
    from tinyram_tpu_torch.entry import dryrun_multichip
    from tinyram_tpu_torch.field import FP
    from tinyram_tpu_torch.ipa.srs import CACHE_DIR, cache_generators, setup
    from tinyram_tpu_torch.poly import ntt
    from tinyram_tpu_torch.shard import RankError, paths, run_on_mesh
    from tinyram_tpu_torch.shard.scaling import scaling_report
    from tinyram_tpu_torch.tinyram import TinyRamCircuit

    t_phase = time.time()
    out = {"seconds": {}, "peak_gib": {}}
    counts = {}

    def timed(name, fn):
        t0 = time.time()
        res = fn()
        out["seconds"][name] = time.time() - t0
        return res

    # (a) the dry run, and a rank that fails
    for d in (2, 4):
        res = timed(f"dryrun {d}", lambda: dryrun_multichip(d, log=log))
        out["peak_gib"][f"dryrun {d} proof"] = _rank_peaks(
            [s["proof"] for s in res["stats"]])
        counts[f"shard dryrun({d}) proof"] = _summed(
            [s["proof"] for s in res["stats"]])
    t0 = time.time()
    try:
        run_on_mesh(paths.raise_on_rank, 2, 1, timeout_s=120, log=log)
    except RankError as e:
        out["seconds"]["failing rank"] = time.time() - t0
        log(f"[shard] a failing rank raised in the parent after "
            f"{out['seconds']['failing rank']:.1f}s: "
            f"{str(e).splitlines()[0]}")
    else:
        raise AssertionError("run_on_mesh returned although a rank raised")

    # the single-device references, on this process
    gen = np.random.default_rng(SEED + 5)
    a = gen.integers(0, 1 << 16, size=(16, 1 << SHARD_NTT_LOG))
    a[15] &= 0x3FFF
    a = a.astype(np.int32)
    a_dev = torch.as_tensor(a, device=dev)
    want = {inv: ntt(FP, a_dev, inverse=inv).cpu().numpy()
            for inv in (False, True)}
    del a_dev
    sc = gen.integers(0, 1 << 16, size=(16, 1 << SHARD_MSM_LOG))
    sc[15] &= 0x3FFF
    sc = sc.astype(np.int32)
    cache_generators(SHARD_MSM_LOG)  # the ranks load both SRS, not hash
    cache_generators(14)
    g18 = setup(SHARD_MSM_LOG, dev, cache_dir=CACHE_DIR).g
    want_msm = to_affine_host(PointBatch(*(c[:, None] for c in msm(
        torch.as_tensor(sc, device=dev), g18))))
    del g18
    torch.cuda.empty_cache()

    ntt_calls = [(paths.ntt_path, (a, False)), (paths.ntt_path, (a, True))]
    runs = {
        2: timed("D=2 ranks: (b) (c) (d)", lambda: run_on_mesh(
            paths.sequence, 2, ntt_calls + [
                (paths.msm_path, (sc, None, SHARD_MSM_LOG)),
                (paths.config_proof, (2, SEED))], log=log)),
        4: timed("D=4 ranks: (b) (d)", lambda: run_on_mesh(
            paths.sequence, 4, ntt_calls + [
                (paths.config_proof, (2, SEED))], log=log)),
    }
    for d, ranks in runs.items():
        for i, inv in enumerate((False, True)):
            name = f"shard ntt 2^{SHARD_NTT_LOG}{' inverse' if inv else ''} D={d}"
            if not all(np.array_equal(r[i][0], want[inv]) for r in ranks):
                raise AssertionError(f"{name}: differs from the single-device ntt")
            stats = [r[i][1] for r in ranks]
            counts[name] = _summed(stats)
            out["seconds"][name] = max(s["seconds"] for s in stats)
            out["peak_gib"][name] = _rank_peaks(stats)
            missing = [k for k in ("B1", "B2") if counts[name][k] == 0]
            if missing:
                raise AssertionError(f"{name}: never launched {missing}")
    ranks = runs[2]
    name = f"shard msm 2^{SHARD_MSM_LOG} D=2"
    if not all(r[2][0] == want_msm for r in ranks):
        raise AssertionError(f"{name}: differs from the single-device msm")
    stats = [r[2][1] for r in ranks]
    counts[name] = _summed(stats)
    out["seconds"][name] = max(s["seconds"] for s in stats)
    out["peak_gib"][name] = _rank_peaks(stats)
    missing = [k for k in MSM_KERNELS if counts[name][k] == 0]
    if missing:
        raise AssertionError(f"{name}: never launched {missing}")

    out["config 2"] = {}
    circ2 = TinyRamCircuit(24, 8)  # config 2's, as `config_proof` builds it
    for d, i in ((2, 3), (4, 2)):
        out["config 2"][d] = _check_sharded_proof(
            d, [r[i] for r in runs[d]], proof2, counts, out,
            paths.gather_pattern(circ2.tcs.cs, circ2.k, d))

    # (e) the scaling report on one card
    rep = timed("scaling report", lambda: scaling_report(
        SHARD_NTT_LOG, SHARD_MSM_LOG, (1, 2, 4), log=log))
    out["scaling"] = rep
    log(f"[shard] scaling on one card (NTT 2^{SHARD_NTT_LOG} elems/s, MSM "
        f"2^{SHARD_MSM_LOG} pts/s): ntt {rep['ntt']}, msm {rep['msm']}, "
        f"efficiency {rep['efficiency']}")
    out["total_s"] = time.time() - t_phase
    out["launches"] = counts
    log(f"[shard] seconds {({k: round(v, 2) for k, v in out['seconds'].items()})}")
    log(f"[shard] peak GiB per rank {out['peak_gib']}")
    log(f"[shard] launches per path, summed over ranks: {counts}")
    log(f"[shard] phase {out['total_s']:.1f}s")
    report["shard"] = out
    return counts


def check_msm_kernels(dev, gen, srs, tables, latency_us: float) -> dict:
    """B3s and B4s at the two MSM shapes the bench adds, against their
    plain versions, bounded as `check_kernels` bounds them: 2^16 points at
    c = 15 (`plan(2^16, 18)`: 18 windows of 1792 chunk lanes, L = 37; B4s
    over 18 windows of H = 128 lanes and S = 128 steps at the stride of
    2^14 + 2 buckets) and 2^20 points at c = 16 in one column (4 windows a
    group of 8192 chunk lanes, L = 128; B4s over 16 windows of H = 256
    lanes, S = 128, stride 2^15 + 2).  B4s runs so few lanes that its
    chain of dependent products bounds it: "chain_ms" is that depth (two
    products per add, 2S on the accumulator's chain) at the product
    latency (`latency_us`) that B6h's one-lane run measured."""
    import torch

    import torch_point_sweep as sweep
    from tinyram_tpu_torch.curve import cuda_point as cp
    from tinyram_tpu_torch.curve.msm import choose_window_bits, plan
    from tinyram_tpu_torch.curve.vesta import PointBatch

    _, product, _ = tables
    out = {}
    record = functools.partial(record_row, out, tag="msm kernel")
    for log_n in (16, 20):
        n = 1 << log_n
        c = choose_window_bits(n)
        nw = -(-256 // c)
        G, lanes_w, L, _ = plan(n, nw)
        M = G * lanes_w
        same = sweep.bucket_same(gen, L, M, lanes_per_window=lanes_w, c=c,
                                 device=dev)
        pick = torch.as_tensor(gen.integers(0, srs.n, size=L * M), device=dev)
        sx, sy = (t[:, pick].reshape(16, L, M).transpose(0, 1).contiguous()
                  for t in (srs.g.x, srs.g.y))
        n_same = int(same.sum())
        kid = f"B3s 2^{log_n}"
        record(kid, lambda: tuple(cp.padd_select_mixed_scan(same, sx, sy)),
               lambda: tuple(cp.madd_select_scan_plain(same, sx, sy)), 2, 1,
               L * M + 2 * FE_BYTES * L * M + 3 * FE_BYTES * L * M,
               product["B3s"], MADD * n_same)
        out[kid].update(same_share=n_same / (L * M), c=c, plan=[G, lanes_w, L])
        del same, sx, sy, pick

        half = c - 1
        S = 1 << (half // 2)
        H = (1 << half) // S
        n_s = nw * H
        p, _, _, _ = projective_points(gen, srs, 1 << 15, dev)
        pick = torch.as_tensor(gen.integers(0, 1 << 15, size=nw * (H * S + 2)),
                               device=dev)
        bk = PointBatch(*(t[:, pick].reshape(16, nw, H * S + 2)[..., :H * S]
                          .reshape(16, nw, H, S) for t in p))
        kid = f"B4s 2^{log_n}"
        record(kid, lambda: tuple(x for part in cp.padd_suffix_scan(bk)
                                  for x in part),
               lambda: tuple(x for part in cp.suffix_scan_plain(bk)
                             for x in part), 3, 1,
               3 * FE_BYTES * S * n_s + 6 * FE_BYTES * n_s, product["B4s"],
               (2 * S - 1) * ADD * n_s)
        out[kid].update(windows=nw, H=H, S=S,
                        chain_ms=2 * S * latency_us / 1e3)
        log(f"[msm kernel] {kid} chain bound {out[kid]['chain_ms']:.4f} ms "
            f"({2 * S} dependent products)")
        del bk, pick, p
    return out


MXU_STAGES = {  # (R, L) of each M1 stage of the bench's transforms
    "2^20": [(128, 8192), (64, 16384)],
    "2^16": [(128, 512), (32, 2048), (16, 4096)],
    "16x2^18": [(128, 32768), (64, 65536), (32, 131072)],
}
INT8_OPS_PER_S = 1979e12  # published dense int8 tensor-core rate (700 W)
AFFINE_PLAN = (32, 1 << 17)  # (L, M) of the affine scan of 2^20, c = 16
CONFIG3_SCAN = (128, 1 << 15)  # (L, M) of config 3's commit scan (B3s)
# Montgomery products of one affine step per lane (x², λ, λ², λ·(x - x3))
# and of Montgomery's trick per lane (the reference's product tree), and of
# the Fermat inversion shared by a step (255 squarings, 127 products)
AFFINE_STEP, TRICK, FERMAT = 4, 3, 382


def mxu_affine_phase(dev, report, tables, proof2: bytes, launches2: dict):
    """Phase 16: the digit-matmul NTT (M1) and the batched-affine MSM (A1,
    A2) on the card; returns (kernel checks, path launch counts)."""
    import importlib

    import numpy as np
    import torch

    import torch_point_sweep as sweep
    from tinyram_tpu_torch import bench_msm, bench_mxu_ntt, kernels
    from tinyram_tpu_torch.curve import cuda_affine, cuda_point as cp
    from tinyram_tpu_torch.curve.vesta import PointBatch, to_affine_host
    from tinyram_tpu_torch.field.field import FP, FQ, FQ_PLAIN
    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.plonk import create_proof
    from tinyram_tpu_torch.poly import cuda_mxu, mxu_ntt
    from tinyram_tpu_torch.probes import device_ms
    from tinyram_tpu_torch.tinyram import TinyRamCircuit, eval_program
    from tinyram_tpu_torch.tinyram.bench_programs import config2_program
    from tinyram_tpu_torch.verify_msm import oracles

    tmsm = importlib.import_module("tinyram_tpu_torch.curve.msm")
    _, product, _ = tables
    gen = np.random.default_rng(SEED + 16)
    out, paths, t = {}, {}, {}
    record = functools.partial(record_row, out, tag="mxu/affine kernel")
    t_phase = time.time()
    for kid in ("M1", "A1", "A2"):
        if launches2.get(kid, 0):
            raise AssertionError(f"the default config-2 proof launched {kid}")

    # (1) M1 at every stage shape of the 2^20, 2^16 and 16 x 2^18 transforms
    t0 = time.time()
    errs = []
    for name, stages in MXU_STAGES.items():
        for R, L in stages:
            log_r = R.bit_length() - 1
            x = device_limbs(gen, (R, L), dev)
            idx = sample(gen, L, 64, dev)
            kid = f"M1 {R}x{L}"
            record(kid, lambda: cuda_mxu.dft_stage_m1(x, "Fp", log_r, False),
                   lambda: mxu_ntt.dft_stage_plain(
                       x[:, :, idx], mxu_ntt._field("Fp"), log_r, False),
                   5, 1, 2 * FE_BYTES * R * L, collections.Counter(), 0,
                   pick=lambda y: y[:, :, idx], plain_lanes=len(idx))
            ops = 2 * mxu_ntt.N_DIGITS ** 2 * R * R * L
            # the bound: the int8 products at the tensor cores' rate
            out[kid].update(bound(
                2 * FE_BYTES * R * L + 37 * max(R, 16) * max(R, 32),
                ops / INT8_OPS_PER_S * 1e3))
            out[kid].update(transform=name, int8_ops=ops)
            log(f"[mxu/affine kernel] {kid}: int8 bound "
                f"{out[kid]['bound_ms']:.4f} ms ({out[kid]['bound_by']}), "
                f"{out[kid]['bound_ms'] / out[kid]['ms']:.1%} of it")
            errs.append(out[kid]["max_abs_err"])
            if name == "2^20":  # the digit product alone, by the library
                W7 = torch.as_tensor(mxu_ntt._dft_digit_matrix(
                    "Fp", log_r, False), device=dev).reshape(37 * R, R)
                X7 = mxu_ntt.limbs_to_digits7(x).permute(1, 0, 2).reshape(
                    R, 37 * L).contiguous()
                try:  # a yardstick only: its failure checks nothing
                    ms = device_ms(lambda: torch._int_mm(W7, X7), 1)
                except RuntimeError as exc:
                    ms = None
                    log(f"[mxu/affine kernel] torch._int_mm failed: {exc}")
                out[kid]["digit_matmul_library_ms"] = ms
                log(f"[mxu/affine kernel] {kid}: torch._int_mm of the digit "
                    f"product alone ({37 * R}x{R} by {R}x{37 * L}): {ms} ms")
                del W7, X7
            del x
            torch.cuda.empty_cache()
    t["m1_stages"] = time.time() - t0
    out["M1"] = dict(out["M1 128x8192"], max_abs_err=max(errs))

    # (2) the bench_mxu_ntt twin: 2^16 and 2^20, then 16 x 2^18
    t0 = time.time()
    kernels.reset_launch_counts()
    rep = bench_mxu_ntt.run([16, 20], device=dev,
                            log=lambda m: log(f"[bench_mxu_ntt] {m}"))
    paths["bench_mxu_ntt 2^16, 2^20"] = kernels.launch_counts()
    kernels.reset_launch_counts()
    rep16 = bench_mxu_ntt.run([18], cols=16, device=dev,
                              log=lambda m: log(f"[bench_mxu_ntt] {m}"))
    paths["bench_mxu_ntt 16x2^18"] = kernels.launch_counts()
    report["bench_mxu_ntt"] = {"1": rep, "16": rep16}
    t["bench_mxu_ntt"] = time.time() - t0
    if not (rep["ok"] and rep16["ok"]):
        raise AssertionError("ntt_mxu differs from the B2 ntt or its inverse")
    for name in ("bench_mxu_ntt 2^16, 2^20", "bench_mxu_ntt 16x2^18"):
        if not (paths[name]["M1"] and paths[name]["B1"]):
            raise AssertionError(f"{name} never launched M1 or B1")

    # (3) A2 on 2^17 lanes with substituted lanes, and zeros left in
    t0 = time.time()
    n = 1 << 17
    d = device_limbs(gen, (n,), dev)
    d[:, sample(gen, n, 64, dev)] = FQ.ones((64,), dev)  # substituted
    record("A2", lambda: cuda_affine.batch_inverse(d),
           lambda: tmsm.batch_inv(d), 5, 1, 2 * FE_BYTES * n,
           product["B4"], TRICK * n + FERMAT * (n >> cuda_affine.group_log2(n)))
    inv = cuda_affine.batch_inverse(d)
    if not (FQ_PLAIN.mul(inv, d) == FQ.ones((n,), dev)).all():
        raise AssertionError("A2: some d * d^-1 is not one")
    z = d[:, :601].clone()
    z[:, [7, 600]] = 0
    zero_same = torch.equal(cuda_affine.batch_inverse(z), tmsm.batch_inv(z))
    log(f"[mxu/affine kernel] A2 with zeros left in equals its plain "
        f"version: {zero_same}")
    if not zero_same:
        raise AssertionError("A2 differs from its plain version on zeros")
    del d, inv, z
    t["a2"] = time.time() - t0

    # (4) A1 at the affine plan of 2^20 (c = 16) and at config 3's commit
    # scan, beside B3s on the same inputs
    t0 = time.time()
    srs = setup(20, dev)
    for (L, M), lanes_w, c in ((AFFINE_PLAN, 1 << 15, 16),
                               (CONFIG3_SCAN, 1 << 12, 16)):
        same = sweep.bucket_same(gen, L, M, lanes_per_window=lanes_w, c=c,
                                 device=dev)
        pick = torch.as_tensor(gen.integers(0, srs.n, size=L * M), device=dev)
        sx, sy = (g[:, pick].reshape(16, L, M).transpose(0, 1).contiguous()
                  for g in (srs.g.x, srs.g.y))
        del pick
        n_same = int(same.sum())
        kid = f"A1 {L}x{M}"
        nbytes = L * M * (2 + 4 * FE_BYTES)
        products = L * ((AFFINE_STEP + TRICK) * M + FERMAT)
        if (L, M) == AFFINE_PLAN:  # the plain scan on a sample of lanes,
            # run once (its Fermat chain of plain products takes seconds a
            # step whatever the lanes) and timed as it runs
            idx = sample(gen, M, 256, dev)
            sync()
            t1 = time.time()
            want = tmsm.affine_scan_plain(same[:, idx], sx[:, :, idx],
                                          sy[:, :, idx])
            sync()
            plain_ms = (time.time() - t1) * 1e3
            record(kid, lambda: cuda_affine.affine_scan(same, sx, sy),
                   lambda: want, 3, 1, nbytes, product["B4"], products,
                   plain_ms=plain_ms,
                   pick=lambda r: (r[0][..., idx], r[1][..., idx],
                                   r[2][..., idx]), plain_lanes=len(idx))
            del want
        else:  # the plain scan would take minutes: against B3s on all lanes
            # as points, limbs first: x·Z = X and y·Z = Y, or both identity
            ax, ay, ainf = cuda_affine.affine_scan(same, sx, sy)
            px, py, pz = (c.transpose(0, 1)
                          for c in cp.padd_select_mixed_scan(same, sx, sy))
            ident = FQ.is_zero(pz)
            agree = torch.equal(ident, ainf) and bool((
                (FQ.mul(ax.transpose(0, 1), pz) == px).all(0)
                & (FQ.mul(ay.transpose(0, 1), pz) == py).all(0)
                | ident).all())
            del ax, ay, ainf, px, py, pz, ident
            ms = device_ms(lambda: cuda_affine.affine_scan(same, sx, sy), 2)
            out[kid] = {"max_abs_err": 0 if agree else 1, "ms": ms,
                        "plain_ms": None, "checked_against": "B3s, all lanes",
                        **bound(nbytes, pipe_ms(product["B4"], products))}
            log(f"[mxu/affine kernel] {kid} equal to B3s as points on every "
                f"lane and step: {agree}; ms={ms:.4f} bound_ms="
                f"{out[kid]['bound_ms']:.4f}")
            if not agree:
                raise AssertionError(f"{kid} differs from B3s")
        out[kid]["b3s_ms"] = device_ms(
            lambda: cp.padd_select_mixed_scan(same, sx, sy), 3)
        out[kid].update(same_share=n_same / (L * M), steps=L, lanes=M)
        log(f"[mxu/affine kernel] {kid}: A1 {out[kid]['ms']:.4f} ms, B3s "
            f"{out[kid]['b3s_ms']:.4f} ms on the same inputs")
        del same, sx, sy
        torch.cuda.empty_cache()
    out["A1"] = out[f"A1 {AFFINE_PLAN[0]}x{AFFINE_PLAN[1]}"]
    t["a1"] = time.time() - t0

    # (5) msm and msm_many with the affine scan against the projective one,
    # and at 2^16 against the host oracle
    t0 = time.time()
    msm_out = {}
    for log_n in (16, 20):
        n = 1 << log_n
        g = PointBatch(*(c[:, :n] for c in srs.g))
        limbs = gen.integers(0, 1 << 16, size=(16, 4, n)).astype(np.int32)
        limbs[15] &= 0x3FFF
        sc = torch.as_tensor(limbs, device=dev)
        res = {}
        sums = {}
        for affine in (False, True):
            name = "affine" if affine else "projective"
            kernels.reset_launch_counts()
            one = tmsm.msm(sc[:, 0], g, affine=affine)
            many = tmsm.msm_many(sc, g, affine=affine)
            sync()
            paths[f"msm+msm_many 2^{log_n} {name}"] = kernels.launch_counts()
            sums[name] = (to_affine_host(PointBatch(*(c[:, None] for c in one))),
                          to_affine_host(many))
            ms = device_ms(lambda: tmsm.msm(sc[:, 0], g, affine=affine), 2,
                           graph=False)
            res[name] = {"ms": ms, "points_per_s": n / (ms * 1e-3)}
        ok = sums["affine"] == sums["projective"]
        if log_n == 16:
            ref = oracles({"col0": FP.decode(sc[:, 0], from_mont=False)},
                          srs.g_host[:n])["col0"]
            ok = ok and sums["affine"][0][0] == ref
        res["equal"] = ok
        msm_out[f"2^{log_n}"] = res
        log(f"[msm affine] 2^{log_n}: affine equals projective"
            f"{' and the host oracle' if log_n == 16 else ''}: {ok}; "
            f"projective {res['projective']['points_per_s']:,.0f} pts/s, "
            f"affine {res['affine']['points_per_s']:,.0f} pts/s")
        if not ok:
            raise AssertionError(f"the affine MSM differs at 2^{log_n}")
        aff = paths[f"msm+msm_many 2^{log_n} affine"]
        if not aff["A1"] or aff["B3s"]:
            raise AssertionError(f"affine MSM at 2^{log_n}: launches {aff}")
        del sc, g
    report["msm_affine"] = msm_out
    t["msm_affine"] = time.time() - t0

    # (6) the bench_msm twin at its defaults
    t0 = time.time()
    kernels.reset_launch_counts()
    rep = bench_msm.run([12, 16], device=dev,
                        log=lambda m: log(f"[bench_msm] {m}"))
    paths["bench_msm 2^12, 2^16"] = kernels.launch_counts()
    report["bench_msm"] = rep
    t["bench_msm"] = time.time() - t0
    if not rep["ok"]:
        raise AssertionError("bench_msm: the affine sum differs")
    missing = [k for k in ("A1", "A2", "B3s", "B5l")
               if not paths["bench_msm 2^12, 2^16"][k]]
    if missing:
        raise AssertionError(f"bench_msm never launched {missing}")

    # (7) config 2 proved with both switches: phase 4's bytes
    t0 = time.time()
    W, R = 24, 8
    prog = config2_program(1 << 12, word_bits=W)
    trace = eval_program(prog, W, R)
    circ = TinyRamCircuit(W, R)
    srs2 = setup(circ.k, dev)
    pk = circ.keygen(srs2)
    asg = circ.assignment(trace, dev)
    kernels.reset_launch_counts()
    t1 = time.time()
    proof = create_proof(srs2, pk, asg, rng=SeededRng(SEED),
                         ntt_method="mxu", msm_affine=True)
    sync()
    prove_s = time.time() - t1
    counts = paths["config2 proof mxu+affine"] = kernels.launch_counts()
    same = proof == proof2
    ok = circ.verify(srs2, pk, prog, trace.answer, proof)
    bad = circ.verify(srs2, pk, prog, trace.answer + 1, proof)
    log(f"[mxu/affine proof] config 2 with ntt_method='mxu', msm_affine=True: "
        f"{prove_s:.2f}s, bytes equal to phase 4's: {same}, verify={ok}, "
        f"answer+1 accepted={bad}; launches {counts}")
    report["proof_mxu_affine"] = {"prove_s": prove_s, "same_bytes": same,
                                  "verify": ok, "launches": counts}
    if not same or not ok or bad:
        raise AssertionError("the mxu/affine proof differs or fails to verify")
    if not (counts["M1"] and counts["A1"]) or counts["B2"]:
        raise AssertionError(f"the mxu/affine proof's launches: {counts}")
    del pk, asg, circ
    t["proof"] = time.time() - t0
    t["total"] = time.time() - t_phase
    report["mxu_affine_s"] = t
    log(f"[mxu/affine] phase seconds {t}")
    return out, paths


def kernel_rows(checks, probe, launches, launches3, paths, checks16) -> list:
    """The kernels line: each kernel at config 2's shapes, its launches in
    one config-2 proof (P1, P2: in the probe path; M1, A1, A2: at phase
    16's shapes, in the path of NEW_KERNELS) and, beside them, in one
    config-3 proof and in each later path (`paths`: name -> counts)."""
    rows = []
    for kid, (name, source, replaces) in KERNELS.items():
        n3 = launches3.get(kid, 0)
        if kid in NEW_KERNELS:
            c = checks16[kid]
            n = paths[NEW_KERNELS[kid]][kid]
        elif kid in checks:
            c = checks[kid]
            n = launches[kid]
        else:
            op, reps = PROBE_ROW[kid]
            c = next(x for x in probe["cases"]
                     if (x["kernel"], x["op"], x["reps"]) == (kid, op, reps))
            name = f"{name} ({op}, reps {reps})"
            n = probe["launches"][kid]
        rows.append({"name": f"{kid} {name}", "route": "cuda",
                     "source": source, "replaces": replaces, "launches": n,
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "library_ms": None,
                     "launches_config3": n3,
                     "launches_paths": {name: counts.get(kid, 0)
                                        for name, counts in paths.items()}})
        if "digit_matmul_library_ms" in c:  # a different function: not
            rows[-1]["digit_matmul_library_ms"] = c["digit_matmul_library_ms"]
    return rows


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]
    from tinyram_tpu_torch import kernels, probes
    from tinyram_tpu_torch.curve import cuda_affine  # noqa: F401 (A1, A2)
    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.poly import cuda_mxu  # noqa: F401 (M1's count)

    dev = torch.device("cuda", 0)
    smi = probes.nvidia_smi()
    log(smi)
    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    t_start = time.time()

    t0 = time.time()
    kernels.library()
    report["build_s"] = time.time() - t0
    log(f"[build] {report['build_s']:.1f}s (nvcc {kernels.build_seconds})")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")
    listing = kernels.sass()
    funcs = kernels.sass_opcodes(listing)

    probe = probe_phase(dev, report, funcs)
    tables = sass_tables(funcs, listing)
    gen = np.random.default_rng(SEED)
    t0 = time.time()
    srs_check = setup(14, dev)
    report["srs_k14_s"] = time.time() - t0
    log(f"[main] srs setup, k=14: {report['srs_k14_s']:.2f}s")
    checks = check_kernels(dev, gen, srs_check, tables)
    report["kernels"] = checks
    del srs_check
    cfg = prove_config(dev, report)
    mock_phase(dev, report, cfg)
    negative_phase(dev, report)
    w16_phase(dev, report)
    batch_phase(dev, report, cfg)
    keyfile_phase(dev, report, cfg)
    golden_check(dev, report)
    launches2 = cfg["launches"]
    proof2 = cfg["proof"]
    del cfg
    torch.cuda.empty_cache()
    srs17 = config3_phase(dev, report)
    report["kernels_config3"] = check_config3_kernels(
        dev, np.random.default_rng(SEED + 3), srs17, tables,
        report["config3"]["widest_launches"]["B1"])
    del srs17
    torch.cuda.empty_cache()

    phase_s = report["phase_s"] = {}
    t0 = time.time()
    entry_phase(dev, report)
    phase_s["entry"] = time.time() - t0
    t0 = time.time()
    verify_msm_phase(dev, report)
    phase_s["verify_msm"] = time.time() - t0
    t0 = time.time()
    report["kernels_msm"] = check_msm_kernels(
        dev, np.random.default_rng(SEED + 4), setup(20, dev), tables,
        checks["B6h"]["product_latency_us"])
    phase_s["msm kernels"] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    bench_phase(dev, report, smi)
    phase_s["bench"] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    shard_counts = shard_phase(dev, report, proof2)
    phase_s["shard"] = time.time() - t0
    torch.cuda.empty_cache()
    t0 = time.time()
    checks16, paths16 = mxu_affine_phase(dev, report, tables, proof2,
                                         launches2)
    report["kernels_mxu_affine"] = checks16
    phase_s["mxu/affine"] = time.time() - t0
    log(f"[phases] seconds {phase_s}; setup(20) "
        f"{report['verify_msm']['setup20_s']:.2f}s")
    report["total_s"] = time.time() - t_start
    log(f"[total] {report['total_s']:.1f}s")

    paths = {"entry": report["entry"]["launches"],
             "verify_msm 2^16": report["verify_msm"]["2^16"]["launches"],
             "verify_msm 2^20": report["verify_msm"]["2^20"]["launches"]}
    for name, res in report["bench"]["results"].items():
        paths[f"bench {name}, per call"] = res["launches"]
    paths.update(shard_counts)
    paths.update(paths16)
    rows = kernel_rows(checks, probe, launches2,
                       report["config3"]["launches"], paths, checks16)
    report["kernel_rows"] = rows
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
