"""The digit-matmul NTT (kernel M1) against the butterfly NTT (kernel B2)
on one card: the twin of `scripts/bench_mxu_ntt.py`.

Usage: python -m tinyram_tpu_torch.bench_mxu_ntt [--cols B] [log sizes ...]
           (default 16 20, one column)

For each size, with the reference's inputs (`np.random.default_rng(0)`
limbs drawn in size order, top limb & 0x3FFF; B columns when `--cols` is
given): the first `ntt(method="mxu")` call's seconds (the kernels' build
on a fresh checkout), its output against `ntt` (B2) bit for bit, both
rates in elements per second (the mean of `ITERS` calls after a warm-up,
between two `torch.cuda.synchronize()`, as the reference times them), and
the inverse round trip.  Prints one line per step, then one JSON line;
exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .bench import _sync
from .field import FP
from .poly.ntt import ntt
from .probes import nvidia_smi
from .utils.device import CUDA, resolve

ITERS = 3


def _seconds(fn, dev, iters: int = ITERS) -> float:
    fn()
    _sync(dev)
    t0 = time.time()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.time() - t0) / iters


def run(logs, cols: int = 1, device=CUDA, log=print) -> dict:
    """The steps at each 2^lg in `logs`; returns {"ok", "sizes": {lg:
    {...}}}.  On a CPU device both methods run the radix-2 stages: that
    run checks the steps, not the kernels."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    out = {"cols": cols, "sizes": {}}
    for lg in logs:
        n = 1 << lg
        shape = (16, n) if cols == 1 else (16, cols, n)
        limbs = rng.integers(0, 1 << 16, size=shape).astype(np.uint32)
        limbs[15] &= 0x3FFF
        a = torch.as_tensor(limbs.view(np.int32), device=dev)
        t0 = time.time()
        got = ntt(FP, a, method="mxu")
        _sync(dev)
        first_s = time.time() - t0
        want = ntt(FP, a)
        match = bool(torch.equal(got, want))
        mxu_s = _seconds(lambda: ntt(FP, a, method="mxu"), dev)
        b2_s = _seconds(lambda: ntt(FP, a), dev)
        back = ntt(FP, got, inverse=True, method="mxu")
        roundtrip = bool(torch.equal(back, a))
        elems = n * cols
        res = {"first_call_s": first_s, "match_b2": match,
               "roundtrip": roundtrip, "mxu_s": mxu_s, "b2_s": b2_s,
               "mxu_elems_per_s": elems / mxu_s, "b2_elems_per_s": elems / b2_s}
        out["sizes"][lg] = res
        log(f"{cols}x2^{lg}: mxu first call {first_s:.1f}s; match vs b2 = "
            f"{match}; mxu {elems / mxu_s / 1e6:.1f}M elems/s   b2 "
            f"{elems / b2_s / 1e6:.1f}M elems/s   speedup {b2_s / mxu_s:.2f}x; "
            f"inverse roundtrip = {roundtrip}")
        del a, got, want, back
        if not (match and roundtrip):
            break
    out["ok"] = all(r["match_b2"] and r["roundtrip"]
                    for r in out["sizes"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("logs", nargs="*", type=int, default=[16, 20])
    ap.add_argument("--cols", type=int, default=1)
    args = ap.parse_args(argv)
    resolve(CUDA)
    print(nvidia_smi(), flush=True)
    out = run(args.logs, args.cols, log=lambda m: print(m, flush=True))
    print("ALL OK" if out["ok"] else "MISMATCH", flush=True)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
