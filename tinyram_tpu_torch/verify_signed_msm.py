"""The signed-digit Pippenger MSM against two independent references, and
its rate, on one card: the twin of `scripts/verify_signed_msm.py`.

Usage: python -m tinyram_tpu_torch.verify_signed_msm [--log-n 16]
           [--rate-logs 16,20] [--iters 2] [--device cuda|cpu]

The reference script's three parts, on its inputs:

1. 256 points `_hash_to_curve(b"signed", i)` and the scalars 0, 1, p - 1,
   then 253 draws of `random.Random(7)`, through the Pippenger path
   (`_msm_pippenger`, whatever the size) at c = 8 and at c = 13, each equal
   to the host oracle `curve/host.py` `msm`;
2. at 2^log_n points (the 256 tiled; 2^16 by default) and scalars drawn by
   `np.random.default_rng(3)` after the reference's unused (3, 16, n)
   draw, Pippenger at the chooser's c equal in affine form to the
   bit-serial ladder `_msm_small` (called directly, past
   `SMALL_MSM_LANES`): two algorithms that share only the point formulas;
3. the rate of `msm` at each 2^rate_log (the tiled points, scalars from the
   same stream): a first call, then `iters` calls between two
   `torch.cuda.synchronize()`.

Prints one line per check and rate, then one JSON line; exits 1 on any
mismatch.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import numpy as np

from .bench import _limbs, _sync, _tensor
from .curve import PointBatch, from_affine_host, host
from .curve.msm import _msm_small, choose_window_bits, msm
from .field import FP
from .ipa.srs import _hash_to_curve
from .tune_msm_window import hex_point, pippenger, run_and_report
from .utils.device import CUDA, resolve
from .verify_msm import _affine

N0 = 256
ORACLE_WINDOWS = (8, 13)


def _tiled(pb: PointBatch, n: int) -> PointBatch:
    return PointBatch(*(c.repeat(1, n // N0) for c in pb))


def run(log_n: int = 16, rate_logs=(16, 20), iters: int = 2, device=CUDA,
        log=print) -> dict:
    """The three parts; returns {"ok", "host_sum", "oracle": {c: {"ok",
    "s", "sum"}}, "ladder": {...}, "rates": {log: {...}}}, sums as hex
    affine (x, y)."""
    if min(log_n, *rate_logs) < 8:
        raise ValueError("sizes below 2^8 cannot tile the 256 points")
    dev = resolve(device)
    out = {"device": str(dev), "oracle": {}, "rates": {}}
    pts = [_hash_to_curve(b"signed", i) for i in range(N0)]
    pb = from_affine_host(pts, dev)
    rng = random.Random(7)
    scalars = [0, 1, FP.modulus - 1] + [rng.randrange(FP.modulus)
                                        for _ in range(N0 - 3)]
    sc = FP.encode(scalars, to_mont=False, device=dev)
    t0 = time.time()
    want = host.msm(scalars, pts)
    out["host_s"] = time.time() - t0
    out["host_sum"] = hex_point(want)
    for c in ORACLE_WINDOWS:
        t0 = time.time()
        got = _affine(pippenger(sc, pb, c))
        ok = got == want
        out["oracle"][c] = {"ok": ok, "s": time.time() - t0,
                            "sum": hex_point(got)}
        log(f"pippenger c={c} @2^8 vs host: {'OK' if ok else 'MISMATCH'} "
            f"({out['oracle'][c]['s']:.1f}s)")

    n = 1 << log_n
    rng2 = np.random.default_rng(3)
    rng2.integers(0, 1 << 16, size=(3, 16, n))  # the reference's unused draw
    big = _tiled(pb, n)
    scb = _tensor(_limbs(rng2, (n,)), dev)
    c = choose_window_bits(n)
    t0 = time.time()
    a = _affine(pippenger(scb, big, c))
    first_s = time.time() - t0
    t0 = time.time()
    b = _affine(_msm_small(scb, big))
    out["ladder"] = {"log_n": log_n, "c": c, "ok": a == b,
                     "pippenger_first_s": first_s,
                     "ladder_s": time.time() - t0}
    log(f"pippenger(c={c}) vs bit-serial @2^{log_n}: "
        f"{'OK' if a == b else 'MISMATCH'} (first {first_s:.1f}s, ladder "
        f"{out['ladder']['ladder_s']:.2f}s)")

    for r in rate_logs:
        nr = 1 << r
        pts_r = big if nr == n else _tiled(pb, nr)
        sc_r = scb if nr == n else _tensor(_limbs(rng2, (nr,)), dev)
        t0 = time.time()
        res = msm(sc_r, pts_r)
        _sync(dev)
        first = time.time() - t0
        t0 = time.time()
        for _ in range(iters):
            res = msm(sc_r, pts_r)
        _sync(dev)
        dt = (time.time() - t0) / iters
        del res
        out["rates"][r] = {"c": choose_window_bits(nr), "first_s": first,
                           "ms": dt * 1e3, "points_per_s": nr / dt}
        log(f"msm @2^{r}: {nr / dt:,.0f} pts/s ({dt * 1e3:.1f} ms, first "
            f"{first:.1f}s)")
    out["ok"] = out["ladder"]["ok"] and all(
        v["ok"] for v in out["oracle"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-n", type=int, default=16)
    ap.add_argument("--rate-logs", default="16,20")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    logs = tuple(int(x) for x in args.rate_logs.split(",") if x)
    return run_and_report(dev, lambda log: run(args.log_n, logs, args.iters,
                                               dev, log=log))


if __name__ == "__main__":
    sys.exit(main())
