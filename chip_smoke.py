#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tinyram_tpu_torch) on one GPU.

Usage: python3 chip_smoke.py   (no arguments; needs one CUDA device)

1. Prints the card's name and power limit and builds the CUDA kernels.
2. Runs each kernel B1-B6 on the card at the main path's shapes and holds
   it against its plain PyTorch version on the same inputs: the outputs
   must be equal limb for limb (tolerance 0: the arithmetic is exact).
3. Drives the main path: BASELINE config 2 (the arithmetic/bitwise loop of
   ~2^12 steps at W=24, 8 registers, k=14) through TinyRamCircuit: SRS
   setup, keygen, witness, create_proof, verify; the proof must verify and
   must be rejected for answer + 1.  Every kernel's launch count is reset
   just before the proof and must be > 0 after it.
4. Proves the W=8 Answer-only program on the card under the seeded random
   stream of tests/data/torch_golden_w8.npz and checks that the proof bytes
   equal the JAX package's recorded proof.

Prints the per-phase seconds and launch counts, the kernels' JSON line,
and as its last line {"ok": true, "device": {...}}.  Any failure raises
(exit code 1) before the last line; without a CUDA device it exits 1 too.
A detailed report goes to chiprun_out/chip_smoke_report.json.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0  # inputs of the kernel checks and the proof's random stream

REPLACES = {
    "B1": ("mont_mul", "tinyram_tpu_torch/csrc/mont_mul.cu",
           "tinyram_tpu/field/pallas_mul.py:134"),
    "B2": ("ntt_rows", "tinyram_tpu_torch/csrc/ntt.cu",
           "tinyram_tpu/poly/pallas_ntt.py:170"),
    "B3": ("madd_select", "tinyram_tpu_torch/csrc/point.cu",
           "tinyram_tpu/curve/pallas_point.py:299"),
    "B4": ("padd", "tinyram_tpu_torch/csrc/point.cu",
           "tinyram_tpu/curve/pallas_point.py:255"),
    "B5": ("padd_select", "tinyram_tpu_torch/csrc/point.cu",
           "tinyram_tpu/curve/pallas_point.py:274"),
    "B6": ("pdouble", "tinyram_tpu_torch/csrc/point.cu",
           "tinyram_tpu/curve/pallas_point.py:324"),
}


class SeededRng:
    """`randbelow(n)` from a seeded `random.Random` (the stream the golden
    fixture's JAX proofs were made with)."""

    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(a, b) -> int:
    import torch

    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def random_limbs(gen, shape, device):
    """Canonical field elements (< 2^254 < p) as (16, *shape) int32."""
    import numpy as np
    import torch

    limbs = gen.integers(0, 1 << 16, size=(16,) + tuple(shape), dtype=np.int64)
    limbs[15] &= 0x3FFF
    return torch.as_tensor(limbs.astype(np.int32), device=device)


def check_kernels(dev, gen, srs) -> dict:
    """B1-B6 against their plain versions at the main path's shapes."""
    import torch

    from tinyram_tpu_torch.curve import cuda_point as cp
    from tinyram_tpu_torch.curve.vesta import PointBatch
    from tinyram_tpu_torch.field.cuda_mul import mont_mul, mont_mul_plain
    from tinyram_tpu_torch.field.field import FP, FP_PLAIN, FQ_PLAIN
    from tinyram_tpu_torch.poly import cuda_ntt
    from tinyram_tpu_torch.poly.ntt import radix2_stages

    out = {}

    def record(kid, kernel, plain, reps, plain_reps):
        got = kernel()
        want = plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ms = gpu_ms(kernel, reps)
        plain_ms = gpu_ms(plain, plain_reps)
        out[kid] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        log(f"[kernel] {kid} max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if err != 0:
            raise AssertionError(f"{kid} disagrees with its plain version")

    # B1 at (16, 2^18): one of the main path's wide elementwise products
    a = random_limbs(gen, (1 << 18,), dev)
    b = random_limbs(gen, (1 << 18,), dev)
    record("B1", lambda: mont_mul(a, b, FP.params),
           lambda: mont_mul_plain(a, b, FP.params), 50, 5)

    # B2 at the first level of a 64-column 2^14 lagrange->coeff: rows of
    # 128 points with the cross twiddles as output multiplier
    x = random_limbs(gen, (64 * 128, 128), dev)
    cross = torch.as_tensor(
        cuda_ntt._cross_twiddles_host("Fp", 7, 7, True), device=dev)
    record("B2", lambda: cuda_ntt.colntt(x, FP, True, cross, None),
           lambda: cuda_ntt.colntt_plain(x, FP, True, cross, None), 20, 2)
    # and a whole batched transform, 16 x 2^17, through the four-step split
    xb = random_limbs(gen, (16, 1 << 17), dev)
    got = cuda_ntt.ntt_cuda(FP, xb)
    want = radix2_stages(FP_PLAIN, xb, False)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    log(f"[kernel] B2 four-step 16x2^17 max_abs_err={err}")
    if err:
        raise AssertionError("four-step NTT disagrees with the plain NTT")

    # B3-B6 at 2^15 lanes: SRS points, random projective scaling, and
    # identity lanes mixed in
    lanes = 1 << 15
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

    p = projective(gx, gy)
    q = projective(gx.roll(7, 1), gy.roll(7, 1))
    mask = torch.as_tensor(gen.random(lanes) < 0.5, device=dev)
    record("B3", lambda: tuple(cp.padd_select_mixed(mask, p, gx, gy)),
           lambda: tuple(cp.madd_select_plain(mask, p, gx, gy)), 50, 3)
    record("B4", lambda: tuple(cp.padd(p, q)),
           lambda: tuple(cp.padd_plain(p, q)), 50, 3)
    record("B5", lambda: tuple(cp.padd_select(mask, p, q)),
           lambda: tuple(cp.padd_select_plain(mask, p, q)), 50, 3)
    record("B6", lambda: tuple(cp.pdouble(p)),
           lambda: tuple(cp.pdouble_plain(p)), 50, 3)
    return out


def main() -> int:

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tinyram_tpu_torch import kernels
    from tinyram_tpu_torch.ipa import setup

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.time()
    kernels.library()
    report["build_s"] = time.time() - t0
    log(f"[build] {report['build_s']:.1f}s (nvcc {kernels.build_seconds})")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[ptxas] {line.strip()}")

    gen = np.random.default_rng(SEED)
    t0 = time.time()
    srs_check = setup(14, dev)
    report["srs_k14_s"] = time.time() - t0
    log(f"[main] srs setup, k=14 (host hash-to-curve): {report['srs_k14_s']:.2f}s")
    checks = check_kernels(dev, gen, srs_check)
    report["kernels"] = checks
    launches = prove_config(dev, report)
    golden_check(dev, report)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    rows = []
    for kid, (name, source, replaces) in REPLACES.items():
        c = checks[kid]
        rows.append({"name": f"{kid} {name}", "route": "cuda",
                     "source": source, "replaces": replaces,
                     "launches": launches[kid],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def prove_config(dev, report) -> dict:
    """The main path at BASELINE config 2."""
    import torch

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
        torch.cuda.synchronize()
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the proof: {missing}")
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
    return launches


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


if __name__ == "__main__":
    sys.exit(main())
