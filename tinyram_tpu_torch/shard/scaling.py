"""Scaling report: NTT and MSM throughput on 1 rank against D ranks.

Port of `tinyram_tpu/shard/scaling.py` and `scripts/run_scaling_report.py`.
For each D of `device_counts` a mesh of D ranks (`run_on_mesh`) times the
sharded NTT of a (16, 2^log_n_ntt) column (`ntt_sharded`, output left
sharded as the JAX program leaves it) and the point-sharded MSM over the
2^log_n_msm SRS generators (`msm_sharded`, partials combined on every
rank): one warm-up call, then `iters` calls between two barriers after the
device finished, so a rate is that of the slowest rank.  The efficiency
of D ranks is rate(D) / (rate(D0) · D / D0) against the first count D0.

Where the D ranks share one card, as on a one-card machine, they add no
device: the efficiency column measures what sharing one card costs, not
scaling across cards; the report's `analysis` says which case it measured.

Usage: python -m tinyram_tpu_torch.shard.scaling [--ntt LOG_N] [--msm LOG_N]
       [--devices 1,2,4] [--device cpu] [--out build/scaling_report.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..curve.vesta import PointBatch
from ..ipa.srs import CACHE_DIR, ROOT, cache_generators, setup
from .launch import describe, run_on_mesh
from .mesh import Mesh, backend_for, rank_devices
from .msm import msm_sharded
from .ntt import ntt_sharded

ITERS = 3


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _rate(mesh: Mesh, fn, iters: int) -> float:
    """Calls per second of `fn` on every rank, after one warm-up call."""
    fn()
    _sync(mesh)
    mesh.barrier()
    t0 = time.time()
    for _ in range(iters):
        fn()
    _sync(mesh)
    mesh.barrier()
    return iters / (time.time() - t0)


def _rank(mesh: Mesh, log_n_ntt: int, log_n_msm: int, iters: int,
          cache_dir: str | None) -> dict:
    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 16, size=(16, 1 << log_n_ntt))
    limbs[15] &= 0x3FFF
    sc = rng.integers(0, 1 << 16, size=(16, 1 << log_n_msm))
    sc[15] &= 0x3FFF
    a = mesh.block(torch.as_tensor(limbs.astype(np.int32), device=mesh.device))
    scd = mesh.block(torch.as_tensor(sc.astype(np.int32), device=mesh.device))
    g = setup(log_n_msm, mesh.device, cache_dir=cache_dir).g
    pts = PointBatch(*(mesh.block(c) for c in g))
    out = {"ntt": _rate(mesh, lambda: ntt_sharded(mesh, a), iters),
           "msm": _rate(mesh, lambda: msm_sharded(mesh, scd, pts), iters)}
    if mesh.device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    return out


def _analysis(devices) -> str:
    cards = {str(d) for d in devices if d.type == "cuda"}
    if not cards:
        return ("CPU ranks: every rank is a process on the same host, so "
                "D ranks add no device; the efficiency column measures the "
                "cost of the partitioned program and its exchanges, not "
                "scaling.")
    if len(cards) < len(devices):
        return ("ranks share one card (gloo, which copies every exchange "
                "through host memory; one rank alone runs NCCL): D ranks "
                "add no device, so the efficiency column measures what "
                "sharing one card costs (the all-to-alls, the partials' "
                "all-gather, D host processes on one card), not multi-GPU "
                "scaling, which one card cannot show.")
    return "one rank per card over NCCL: the efficiency column is scaling."


def scaling_report(log_n_ntt: int = 16, log_n_msm: int = 10,
                   device_counts=None, device=None, iters: int = ITERS,
                   cache_dir: str | None = CACHE_DIR, log=print) -> dict:
    """{"ntt": {D: elems/s}, "msm": {D: points/s}, "efficiency": {...},
    "sizes", "seconds", "backend", "analysis"}; the ranks run on `device`
    ("cpu") or, when None, on the card(s) (`rank_devices`)."""
    counts = list(device_counts or (1, 2, 4))
    if cache_dir is not None:
        cache_generators(log_n_msm, cache_dir)  # the ranks load, not hash
    report = {"ntt": {}, "msm": {}, "seconds": {}, "backend": {},
              "peak_bytes": {}}
    for d in counts:
        devices = rank_devices(d, device)
        t0 = time.time()
        ranks = run_on_mesh(_rank, d, log_n_ntt, log_n_msm, iters, cache_dir,
                            device=device, log=log)
        report["seconds"][d] = time.time() - t0
        report["backend"][d] = describe(devices, backend_for(devices))
        report["ntt"][d] = round(ranks[0]["ntt"] * (1 << log_n_ntt))
        report["msm"][d] = round(ranks[0]["msm"] * (1 << log_n_msm))
        report["peak_bytes"][d] = [r.get("peak_bytes", 0) for r in ranks]
    base = counts[0]
    report["efficiency"] = {
        kind: {d: round(report[kind][d] / (report[kind][base] * d / base), 3)
               for d in counts}
        for kind in ("ntt", "msm")}
    report["sizes"] = {"ntt": 1 << log_n_ntt, "msm": 1 << log_n_msm}
    report["analysis"] = _analysis(rank_devices(max(counts), device))
    if device is None:
        report["device"] = torch.cuda.get_device_name(0)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ntt", type=int, default=16, help="log2 NTT size")
    ap.add_argument("--msm", type=int, default=10, help="log2 MSM size")
    ap.add_argument("--devices", default="1,2,4", help="rank counts")
    ap.add_argument("--device", default=None, help="cpu (default: the card)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "scaling_report.json"))
    args = ap.parse_args(argv)
    rep = scaling_report(args.ntt, args.msm,
                         [int(d) for d in args.devices.split(",")], args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=2)
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
