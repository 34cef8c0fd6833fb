#!/usr/bin/env python3
"""A BASELINE config proved by `create_proof(mesh=)` on D ranks, per rank.

Usage: python3 scripts/torch_prove_sharded.py [--config 2] [--devices 2]
           [--seed 0] [--root DIR]

Hashes (or finds) the configuration's SRS in the checkout's build/cache/,
then runs `shard.paths.config_proof` on D ranks (`run_on_mesh`: every rank
on the card(s) as `rank_devices` maps them) under `SeededRng(seed)`, and
prints one JSON line: the card, the checkout, whether the ranks' bytes are
equal, verified and answer + 1 rejected, and per rank its prove seconds,
the seconds of the prover's phases, its peak GiB, the peak at the
end of each phase and the field elements each collective kind sent in
each phase (where the checkout records them).  --root DIR
runs the `tinyram_tpu_torch` of another checkout (a parent commit), so two
commits can be compared in one call: parent, change, change, parent.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    args = sys.argv[1:]

    def opt(name, default):
        return args[args.index(name) + 1] if name in args else default

    root = os.path.abspath(opt("--root", ROOT))
    config, devices = int(opt("--config", 2)), int(opt("--devices", 2))
    seed = int(opt("--seed", 0))
    sys.path.insert(0, root)
    from tinyram_tpu_torch.ipa.srs import cache_generators
    from tinyram_tpu_torch.probes import nvidia_smi
    from tinyram_tpu_torch.shard import paths, run_on_mesh
    from tinyram_tpu_torch.tinyram.circuit import TinyRamCircuit
    from tinyram_tpu_torch.tinyram.prove_config import (CONFIGS, REG_COUNT,
                                                        WORD_BITS)

    cache_generators(TinyRamCircuit(WORD_BITS, REG_COUNT,
                                    k=CONFIGS[config][2]).k)
    ranks = run_on_mesh(paths.config_proof, devices, config, seed,
                        log=lambda m: print(m, file=sys.stderr))
    print(json.dumps({
        "nvidia_smi": nvidia_smi(), "root": root, "config": config,
        "devices": devices, "bytes_equal": len({r["proof"] for r in ranks}) == 1,
        "verified": ranks[0]["verified"], "rejected": ranks[-1]["rejected"],
        "ranks": [{"prove_s": r["stats"]["seconds"],
                   "phases": r["stats"]["phases"],
                   "peak_gib": r["stats"]["peak_bytes"] / 2**30,
                   "phase_peak_gib": r["stats"].get("phase_peak_gib"),
                   "phase_collectives": {
                       ph: {kind: v["elements"] for kind, v in c.items()}
                       for ph, c in r["stats"].get(
                           "phase_collectives", {}).items()}}
                  for r in ranks]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
