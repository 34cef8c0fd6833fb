"""Where the port's config-2 proof spends its time on the GPU.

Usage: python scripts/torch_profile_prover.py [--root CHECKOUT] [--warm N]
                                              [--out chiprun_out/profile_config2.txt]

Builds BASELINE config 2 (the arithmetic/bitwise loop, 2^12 steps, W=24,
8 registers, k=14) with the PyTorch port, proves it once to warm the lazy
tables (counting the lanes of every point-kernel launch), N more times to
time the warm proof's seven phases, once under cProfile (the host's Python
functions) and once under torch.profiler (CPU and CUDA activity); then
times the MSM layer alone: `msm_many` at the proof's commit shapes (2^14
SRS points, 4 and 64 columns of random scalars), wall ms per call after a
synchronize and the point-kernel launches per call.  Prints the card
(name, power limit), the point kernels' launches by lane count, the
phases, the top host functions, the device's busy time (the sum of its
kernels' times; one stream, so they do not overlap) against the wall time
of the profiled proof, the kernels and operators that take the most
device time, and the MSM times.  The full operator tables go to --out.  `--root` imports
`tinyram_tpu_torch` from another checkout (an unpacked parent commit,
say), so two versions can be profiled in one call.  Needs a CUDA device;
without one it exits 1.
"""

from __future__ import annotations

import argparse
import collections
import cProfile
import io
import json
import os
import pstats
import random
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


class SeededRng:
    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose tinyram_tpu_torch is profiled")
    ap.add_argument("--warm", type=int, default=1,
                    help="warm proofs timed after the first")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_config2.txt"))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_prover: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from tinyram_tpu_torch import kernels
    from tinyram_tpu_torch.curve import cuda_point, msm_many
    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.plonk import create_proof
    from tinyram_tpu_torch.tinyram import TinyRamCircuit, eval_program
    from tinyram_tpu_torch.tinyram.bench_programs import config2_program
    from tinyram_tpu_torch.utils.profiling import counters

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    W = 24
    prog = config2_program(1 << 12, word_bits=W)
    trace = eval_program(prog, W, 8)
    circ = TinyRamCircuit(W, 8)
    srs = setup(circ.k, dev)
    pk = circ.keygen(srs)
    asg = circ.assignment(trace, dev)

    def prove():
        t0 = time.time()
        proof = create_proof(srs, pk, asg, rng=SeededRng(0))
        torch.cuda.synchronize()
        return proof, time.time() - t0

    # the point kernels' launches of one proof by lane count: every one
    # goes through cuda_point._run, whose last size is the lane count
    lanes = collections.defaultdict(collections.Counter)
    run = cuda_point._run

    def counting_run(name, wrapper, device, tensors, *sizes):
        lanes[wrapper.__name__][sizes[-1]] += 1
        return run(name, wrapper, device, tensors, *sizes)

    cuda_point._run = counting_run
    _, cold = prove()
    cuda_point._run = run
    hist = {k: dict(sorted(c.items())) for k, c in sorted(lanes.items())}
    print(f"point-kernel launches by lanes ({os.path.abspath(args.root)}): "
          f"{sum(sum(c.values()) for c in lanes.values())} in all")
    print(json.dumps({"lanes_per_launch": hist}))
    warm, phases = [], collections.defaultdict(list)
    for _ in range(args.warm):
        counters.ops.clear()
        counters.seconds.clear()
        warm.append(prove()[1])
        for k, v in counters.report().items():
            phases[k].append(v["seconds"])
    print(f"W={W} k={circ.k} steps={len(trace)}: cold prove {cold:.2f}s, "
          f"warm prove {sorted(warm)[len(warm) // 2]:.2f}s (median of "
          f"{', '.join(f'{w:.2f}' for w in warm)})")
    for name, s in phases.items():
        print(f"  {name}: {', '.join(f'{x:.3f}' for x in s)}s")

    # host side: the Python functions the warm proof spends its time in
    pr = cProfile.Profile()
    pr.enable()
    _, wall_py = prove()
    pr.disable()
    print(f"cProfile'd prove {wall_py:.2f}s wall; top cumulative host time:")
    text = io.StringIO()
    pstats.Stats(pr, stream=text).sort_stats("cumulative").print_stats(40)
    print("\n".join(text.getvalue().splitlines()[:60]))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        proof, wall = prove()
    events = prof.key_averages()
    # kernel rows only: an operator's row repeats its kernels' device time
    kernel_rows = [e for e in events
                   if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernel_rows)
    all_rows_us = sum(_device_us(e) for e in events)
    host_us = sum(float(e.self_cpu_time_total) for e in events)
    print(f"profiled prove {wall:.2f}s wall; device busy {busy_us / 1e6:.3f}s "
          f"({100 * busy_us / 1e6 / wall:.1f}% of wall) over "
          f"{sum(e.count for e in kernel_rows)} kernels; device time summed "
          f"over all rows {all_rows_us / 1e6:.3f}s; host self time in torch "
          f"ops {host_us / 1e6:.2f}s")
    by_device = sorted(events, key=_device_us, reverse=True)
    print("top device time (name, calls, device s):")
    for e in by_device[:15]:
        print(f"  {e.key[:70]:70s} {e.count:8d} {_device_us(e) / 1e6:9.3f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps({"lanes_per_launch": hist}) + "\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=60))
        f.write("\n")
        f.write(events.table(sort_by="self_device_time_total"
                             if hasattr(by_device[0], "self_device_time_total")
                             else "self_cuda_time_total", row_limit=60))
    print(f"tables written to {args.out}")

    # the MSM layer alone, at the commit passes' shapes
    n, reps = srs.g.x.shape[-1], 5
    for cols in (4, 64):
        limbs = torch.randint(0, 1 << 16, (16, cols, n), dtype=torch.int32,
                              device=dev)
        limbs[15] &= 0x3FFF  # scalars below 2^254 < p, plain form
        msm_many(limbs, srs.g)
        torch.cuda.synchronize()
        before = kernels.total_launches()
        times = []
        for _ in range(reps):
            t0 = time.time()
            msm_many(limbs, srs.g)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
        print(f"msm_many, {cols} columns of 2^{n.bit_length() - 1} points: "
              f"{sorted(times)[reps // 2]:.2f} ms median of "
              f"{', '.join(f'{t:.2f}' for t in times)}; "
              f"{(kernels.total_launches() - before) // reps} point and field "
              "kernel launches per call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
