#!/usr/bin/env python3
"""BASELINE config 3 on one GPU through the PyTorch port: the twin of
scripts/prove_config3.py (its flags, its W = 24, k = 17).

Usage: python3 scripts/torch_prove_config3.py [--mock] [--prove]
           [--warm N] [--profile] [steps_log2=16]

Emulates 2^steps_log2 steps with the Python and the native emulator
(equal traces required) and builds the witness; --mock runs the port's
MockProver on the card; --prove sets up the SRS, loads or makes the key
(both cached in build/cache/), proves, verifies, and checks that answer + 1
is rejected; --warm N proves N more times in the same process (tables
built, kernels loaded).  --profile runs the whole under cProfile and
writes the top functions by cumulative and by own time to
chiprun_out/config3_profile.txt.
Writes chiprun_out/config3_report.json and prints it as the last line.
"""

import cProfile
import io
import json
import os
import pstats
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    from tinyram_tpu_torch.probes import nvidia_smi
    from tinyram_tpu_torch.tinyram.prove_config import prove_config

    args = sys.argv[1:]
    warm = int(args[args.index("--warm") + 1]) if "--warm" in args else 0
    steps_log2 = next((int(a) for i, a in enumerate(args)
                       if a.isdigit() and (i == 0 or args[i - 1] != "--warm")), 16)
    print(nvidia_smi(), flush=True)
    prof = cProfile.Profile() if "--profile" in args else None
    if prof:
        prof.enable()
    report = prove_config(3, steps_log2, mock="--mock" in args,
                          prove="--prove" in args, warm=warm,
                          log=lambda m: print(m, flush=True))
    if prof:
        prof.disable()
        text = io.StringIO()
        for key in ("cumulative", "tottime"):
            pstats.Stats(prof, stream=text).sort_stats(key).print_stats(60)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "config3_profile.txt"), "w") as f:
            f.write(text.getvalue())
    report.pop("objects")
    report["device"] = torch.cuda.get_device_name(0)
    report["nvidia_smi"] = nvidia_smi()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "config3_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
