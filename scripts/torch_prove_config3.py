#!/usr/bin/env python3
"""BASELINE config 3 on one GPU through the PyTorch port: the twin of
scripts/prove_config3.py (its flags, its W = 24, k = 17).

Usage: python3 scripts/torch_prove_config3.py [--mock] [--prove]
           [--warm N] [--profile] [steps_log2=16]
       python3 scripts/torch_prove_config3.py --mesh D [--seed S]

Emulates 2^steps_log2 steps with the Python and the native emulator
(equal traces required) and builds the witness; --mock runs the port's
MockProver on the card; --prove sets up the SRS, loads or makes the key
(both cached in build/cache/), proves, verifies, and checks that answer + 1
is rejected; --warm N proves N more times in the same process (tables
built, kernels loaded).  --profile runs the whole under cProfile and
writes the top functions by cumulative and by own time to
chiprun_out/config3_profile.txt.
Writes chiprun_out/config3_report.json and prints it as the last line.

--mesh D proves config 3 (2^16 steps) twice under the seeded stream
`shard.paths.SeededRng(S)` (S = 0 by default): on one device, which
caches the SRS and the key in build/cache/, then by `create_proof(mesh=)`
on D ranks (`run_on_mesh(shard.paths.config_proof, D, 3, S)`, every rank
on the card(s) as `rank_devices` maps them, a deadline of 20 minutes),
each rank printing its phases as it ends them.  The bytes must be equal on
every rank and to the single-device proof, rank 0 must verify it and the
last rank reject answer + 1.  Writes chiprun_out/config3_mesh_report.json
(per rank: prove and phase seconds, peak, launches, the collectives of
each phase) and prints it as the last line; a run that fails or passes
its deadline is recorded there with the ranks' errors, and exits 1.
Every rank's all-gather a prover phase must be `shard.paths.gather_pattern`'s
(the coefficient stacks stay row blocks); the report has the peak at the
end of each phase.  D = 2 and D = 4 run on the one card of a one-card
machine.
"""

import cProfile
import io
import json
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


MESH_DEADLINE_S = 1200.0


def mesh_main(n_devices: int, seed: int) -> int:
    import gc

    import torch

    from tinyram_tpu_torch.probes import nvidia_smi
    from tinyram_tpu_torch.shard import RankError, paths, run_on_mesh
    from tinyram_tpu_torch.tinyram.circuit import TinyRamCircuit
    from tinyram_tpu_torch.tinyram.prove_config import (REG_COUNT, WORD_BITS,
                                                        prove_config)

    smi = nvidia_smi()
    print(smi, flush=True)
    single = prove_config(3, mock=False, prove=True,
                          rng=paths.SeededRng(seed),
                          log=lambda m: print(m, flush=True))
    proof = single.pop("objects")["proof"]
    gc.collect()
    torch.cuda.empty_cache()
    report = {"nvidia_smi": smi, "seed": seed, "devices": n_devices,
              "single": {"prove_s": single["seconds"]["prove"],
                         "peak_gib": single["peak_bytes"]["prove"] / 2**30,
                         "phases": single["phases"],
                         "launches": single["launches"]}}
    t0 = time.time()
    try:
        ranks = run_on_mesh(paths.config_proof, n_devices, 3, seed,
                            paths.CACHE_DIR, True, timeout_s=MESH_DEADLINE_S)
    except RankError as e:
        report["error"] = str(e)
        ranks = None
    report["mesh_s"] = time.time() - t0
    if ranks is not None:
        report["ranks"] = [{k: r["stats"][k] for k in (
            "seconds", "phases", "phase_collectives", "phase_peak_gib",
            "collectives", "launches")}
            | {"peak_gib": r["stats"]["peak_bytes"] / 2**30} for r in ranks]
        report["equal_on_every_rank"] = len({r["proof"] for r in ranks}) == 1
        report["equal_to_single"] = ranks[0]["proof"] == proof
        report["verified"] = ranks[0]["verified"]
        report["rejected"] = ranks[-1]["rejected"]
        circ = TinyRamCircuit(WORD_BITS, REG_COUNT, k=ranks[0]["k"])
        pattern = paths.gather_pattern(circ.tcs.cs, circ.k, n_devices)
        report["gather_pattern"] = pattern
        report["gather_pattern_held"] = all(
            paths.gathered_by_phase(r["stats"]) == pattern
            and r["stats"]["collectives"].get("all_gather", 0)
            == sum(pattern.values()) for r in ranks)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "config3_mesh_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    ok = ranks is not None and all(report[k] for k in (
        "equal_on_every_rank", "equal_to_single", "verified", "rejected",
        "gather_pattern_held"))
    return 0 if ok else 1


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    from tinyram_tpu_torch.probes import nvidia_smi
    from tinyram_tpu_torch.tinyram.prove_config import prove_config

    args = sys.argv[1:]
    if "--mesh" in args:
        seed = int(args[args.index("--seed") + 1]) if "--seed" in args else 0
        return mesh_main(int(args[args.index("--mesh") + 1]), seed)
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
