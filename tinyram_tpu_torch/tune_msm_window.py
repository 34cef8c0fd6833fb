"""The Pippenger MSM's time at each window width c on one card: the twin of
`scripts/tune_msm_window.py`.

Usage: python -m tinyram_tpu_torch.tune_msm_window [log_n=16] [c1,c2,...]
           [--runs N] [--device cuda|cpu]            (default c = 12..16)

The reference's inputs: the 2^log_n generators of `setup(log_n)` (cached
in build/cache/) and scalars of 16-bit limbs from `np.random.default_rng(5)`
with the top limb & 0x3FFF.  Prints the analytic chooser's c
(`curve.msm.choose_window_bits`), then for each c one warm-up
`_msm_pippenger(scalars, g, c)` and `--runs` timed runs (two, as the
reference), each between two `torch.cuda.synchronize()`: K points/s and ms
a run (their mean; "ms_runs" holds each run's).  Beyond the reference,
the window changes no result: each c's sum must equal the chooser's c's in
affine form, and up to 2^16 points also the bit-serial ladder's
(`_msm_small`).  Prints one JSON line last; exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .bench import _limbs, _sync, _tensor
from .curve.msm import _msm_pippenger, _msm_small, choose_window_bits
from .ipa.srs import CACHE_DIR, setup
from .utils.device import CUDA, resolve
from .verify_msm import _affine

DEFAULT_WINDOWS = (12, 13, 14, 15, 16)
SMALL_MAX_LOG = 16  # up to 2^16 points each sum is also held to the ladder


def scalars(n: int, device) -> torch.Tensor:
    """The reference's (16, n) plain scalar limbs."""
    return _tensor(_limbs(np.random.default_rng(5), (n,)), device)


def hex_point(pt):
    """An affine host point as [hex x, hex y] (None: the identity)."""
    return None if pt is None else [hex(v) for v in pt]


def pippenger(sc, g, c):
    """The Pippenger path at window width c, batch ()."""
    out = _msm_pippenger(sc[:, None], g, c)
    return type(out)(*(coord[:, 0] for coord in out))


def run(log_n: int, windows=DEFAULT_WINDOWS, device=CUDA, log=print,
        runs: int = 2) -> dict:
    """Times and sums at each c; returns {"ok", "chooser_c", "fastest_c",
    "windows": {c: {"ms", "ms_runs", "kpts_s", "first_s", "equal"}}, "sum":
    the chooser's c's sum as hex affine (x, y), ...}."""
    dev = resolve(device)
    n = 1 << log_n
    t0 = time.time()
    srs = setup(log_n, dev, cache_dir=CACHE_DIR)
    sc = scalars(n, dev)
    chooser = choose_window_bits(n)
    out = {"log_n": log_n, "n": n, "device": str(dev), "chooser_c": chooser,
           "setup_s": time.time() - t0, "windows": {}}
    log(f"n=2^{log_n}; analytic chooser says c={chooser}")
    sums = {}
    for c in dict.fromkeys([chooser, *windows]):
        t0 = time.time()
        sums[c] = _affine(pippenger(sc, srs.g, c))
        first_s = time.time() - t0
        if c not in windows:  # the chooser's reference sum only
            continue
        times = []
        for _ in range(runs):
            _sync(dev)
            t0 = time.time()
            pippenger(sc, srs.g, c)
            _sync(dev)
            times.append(time.time() - t0)
        dt = sum(times) / runs
        out["windows"][c] = {"ms": dt * 1e3, "ms_runs": [t * 1e3 for t in times],
                             "kpts_s": n / dt / 1e3,
                             "first_s": first_s,
                             "equal": sums[c] == sums[chooser]}
        log(f"c={c:2d}: {n / dt / 1e3:8.1f} K pts/s ({dt * 1e3:.1f} ms); sum "
            f"equal to c={chooser}'s: {out['windows'][c]['equal']}")
    out["fastest_c"] = min(out["windows"], key=lambda c: out["windows"][c]["ms"])
    out["sum"] = hex_point(sums[chooser])
    out["small_equal"] = None
    if log_n <= SMALL_MAX_LOG:
        t0 = time.time()
        out["small_equal"] = _affine(_msm_small(sc, srs.g)) == sums[chooser]
        out["small_s"] = time.time() - t0
        log(f"bit-serial ladder (_msm_small) equal: {out['small_equal']}")
    out["ok"] = all(w["equal"] for w in out["windows"].values()) and \
        out["small_equal"] is not False
    return out


def run_and_report(dev, run_fn) -> int:
    """The MSM CLIs' tail: on the card its `nvidia_smi` line first, then
    out = run_fn(log), "ALL OK" or "MISMATCH" and out as one JSON line;
    exit code 0 if out["ok"]."""
    smi = None
    if dev.type == "cuda":
        from .probes import nvidia_smi

        smi = nvidia_smi()
        print(smi, flush=True)
    out = run_fn(lambda m: print(m, flush=True))
    out["nvidia_smi"] = smi
    print("ALL OK" if out["ok"] else "MISMATCH", flush=True)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_n", type=int, nargs="?", default=16)
    ap.add_argument("windows", nargs="?",
                    default=",".join(map(str, DEFAULT_WINDOWS)))
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    windows = tuple(int(c) for c in args.windows.split(","))
    return run_and_report(dev, lambda log: run(args.log_n, windows, dev,
                                               log=log, runs=args.runs))


if __name__ == "__main__":
    sys.exit(main())
