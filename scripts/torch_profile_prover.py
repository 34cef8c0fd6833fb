"""Where the port's config-2 proof spends its time on the GPU.

Usage: python scripts/torch_profile_prover.py [--out chiprun_out/profile_config2.txt]

Builds BASELINE config 2 (the arithmetic/bitwise loop, 2^12 steps, W=24,
8 registers, k=14) with the PyTorch port, proves it once to warm the lazy
tables, once more to time the warm proof's seven phases, once under
cProfile (the host's Python functions) and once under torch.profiler (CPU
and CUDA activity).  Prints the card (name, power limit), the phases, the
top host functions, the device's busy time (the sum of its kernels' times;
one stream, so they do not overlap) against the wall time of the profiled
proof, and the kernels and operators that take the most device time.  The
full operator tables go to --out.  Needs a CUDA device; without one it
exits 1.
"""

from __future__ import annotations

import argparse
import cProfile
import io
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
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "profile_config2.txt"))
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_prover: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
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

    _, cold = prove()
    counters.ops.clear()
    counters.seconds.clear()
    _, warm = prove()
    phases = {k: v["seconds"] for k, v in counters.report().items()}
    print(f"W={W} k={circ.k} steps={len(trace)}: cold prove {cold:.2f}s, "
          f"warm prove {warm:.2f}s")
    for name, s in phases.items():
        print(f"  {name}: {s:.3f}s")

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
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=60))
        f.write("\n")
        f.write(events.table(sort_by="self_device_time_total"
                             if hasattr(by_device[0], "self_device_time_total")
                             else "self_cuda_time_total", row_limit=60))
    print(f"tables written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
