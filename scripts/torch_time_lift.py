#!/usr/bin/env python3
"""The quotient's two lifts timed against each other on the card.

Usage: python3 scripts/torch_time_lift.py [configs=2,3]

BASELINE configs 2 and 3 (W = 24, `prove_config.CONFIGS`) are proved under
one seeded stream with the quotient lifted to the whole extended coset
(what their free memory chooses, `plonk.prover._lift_whole`) and one coset
at a time (within `utils.device.memory_cap(0)`, as config 4's is): one
untimed proof of each lift, then whole, coset, coset, whole, every proof's
bytes equal.  Each timed proof's seconds, its phases' seconds and its
peak device memory go to chiprun_out/lift_report.json with the card's name
and power limit, which is printed as the last line.  Exits 1 if the bytes
differ.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "lift_report.json")
ORDER = ("whole", "coset", "coset", "whole")


def main(argv=None) -> int:
    import contextlib

    import torch

    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.ipa.srs import CACHE_DIR
    from tinyram_tpu_torch.plonk import create_proof
    from tinyram_tpu_torch.probes import nvidia_smi
    from tinyram_tpu_torch.shard.paths import SeededRng
    from tinyram_tpu_torch.tinyram.circuit import TinyRamCircuit
    from tinyram_tpu_torch.tinyram.emulator import eval_program
    from tinyram_tpu_torch.tinyram.prove_config import (CONFIGS, REG_COUNT,
                                                        WORD_BITS)
    from tinyram_tpu_torch.utils.device import CUDA, memory_cap, resolve

    argv = sys.argv[1:] if argv is None else argv
    configs = [int(c) for c in (argv[0] if argv else "2,3").split(",")]
    dev = resolve(CUDA)
    report = {"card": nvidia_smi(), "order": ORDER, "configs": {}}
    ok = True
    for config in configs:
        program, steps_log2, k = CONFIGS[config]
        prog = program(1 << steps_log2, word_bits=WORD_BITS)
        trace = eval_program(prog, WORD_BITS, REG_COUNT)
        circ = TinyRamCircuit(WORD_BITS, REG_COUNT, k=k)
        srs = setup(circ.k, dev, cache_dir=CACHE_DIR)
        pk = circ.keygen(srs)
        asg = circ.assignment(trace, dev)

        def prove(lift):
            phases = {}
            cap = memory_cap(0) if lift == "coset" else contextlib.nullcontext()
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            with cap:
                proof = create_proof(
                    srs, pk, asg, rng=SeededRng(0),
                    phase_hook=lambda name, s, n: phases.__setitem__(name, s))
            torch.cuda.synchronize(dev)
            return proof, {"lift": lift, "seconds": time.perf_counter() - t0,
                           "phases": phases,
                           "peak_gib": torch.cuda.max_memory_allocated(dev)
                           / 2**30}

        first = {lift: prove(lift)[0] for lift in ("whole", "coset")}
        runs = []
        for lift in ORDER:
            proof, row = prove(lift)
            row["equal"] = proof == first["whole"]
            runs.append(row)
            print(f"[lift] config {config} {lift}: {row['seconds']:.3f}s, "
                  f"quotient phase {row['phases']['constraint ext eval']:.3f}s,"
                  f" peak {row['peak_gib']:.3f} GiB, bytes equal "
                  f"{row['equal']}", flush=True)
        same = first["coset"] == first["whole"] and all(r["equal"] for r in runs)
        ok = ok and same
        report["configs"][config] = {"k": circ.k, "equal": same, "runs": runs}
        del asg, pk, srs
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
