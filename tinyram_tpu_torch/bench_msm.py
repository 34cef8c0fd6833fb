"""MSM throughput of the projective and the batched-affine bucket scan on
one card: the twin of `scripts/bench_msm.py`.

Usage: python -m tinyram_tpu_torch.bench_msm [log_n ...]   (default 12 16)

Points are made on the card as the reference makes them: n scalar
multiples k_i·G of `_hash_to_curve(b"bench", 0)` with k_i's 255 bits drawn
by `np.random.default_rng(seed)` (seed = log_n), one launch of the ladder
B5l.  Those points are projective, and the reference feeds them to `msm`
as they are, whose Pippenger path needs affine-or-identity points, so its
sums are wrong (its times are those of the same work).  Here they are
normalized to affine first, by one batched inverse of z (kernel A2).  The
scalars are the reference's (`default_rng(100 + log_n)` limbs, top limb &
0x3FFF).  For each scan (`msm(affine=False)`, then `affine=True`): the
first call's seconds and points per second over 3 calls (1 past 2^16),
between two `torch.cuda.synchronize()`; the two sums must be equal.  Up to
2^15 points `msm` takes the bit-serial ladder on either switch.  Prints
one line per step, then one JSON line; exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .bench import _sync
from .curve.cuda_affine import batch_inverse
from .curve.msm import SMALL_MSM_LANES, choose_window_bits, msm
from .curve.vesta import PointBatch, from_affine_host, scalar_mul
from .field import FQ
from .ipa.srs import _hash_to_curve
from .probes import nvidia_smi
from .utils.device import CUDA, resolve
from .verify_msm import _affine


def gen_points_device(n: int, seed: int, device=CUDA) -> PointBatch:
    """n points k_i·G, projective, as the reference makes them."""
    base = _hash_to_curve(b"bench", 0)
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(rng.integers(0, 2, size=(255, n)).astype(np.uint8),
                           device=device)
    g = from_affine_host([base], device)
    return scalar_mul(bits, PointBatch(*(c.expand(16, n).contiguous()
                                         for c in g)))


def normalize(p: PointBatch) -> PointBatch:
    """(X : Y : Z) -> (X/Z, Y/Z, 1), the identity as (0, 1, 0): one batched
    inverse of z (A2), zero lanes substituted with one."""
    ident = FQ.is_zero(p.z)
    n = p.z.shape[-1]
    one = FQ.ones((n,), p.z.device)
    zi = batch_inverse(FQ.select(ident, one, p.z))
    x = FQ.select(ident, FQ.zeros((n,), p.z.device), FQ.mul(p.x, zi))
    y = FQ.select(ident, one, FQ.mul(p.y, zi))
    return PointBatch(x, y, FQ.select(ident, FQ.zeros((n,), p.z.device), one))


def run(logs, device=CUDA, log=print) -> dict:
    """The steps at each 2^log_n in `logs`; returns {"ok", "sizes":
    {log_n: {...}}}."""
    dev = resolve(device)
    out = {"sizes": {}}
    for log_n in logs:
        n = 1 << log_n
        c = choose_window_bits(n)
        t0 = time.time()
        pts = normalize(gen_points_device(n, log_n, dev))
        _sync(dev)
        gen_s = time.time() - t0
        log(f"n=2^{log_n}: points generated and normalized in {gen_s:.1f}s; "
            f"c={c}")
        rng = np.random.default_rng(100 + log_n)
        limbs = rng.integers(0, 1 << 16, size=(16, n)).astype(np.uint32)
        limbs[15] &= 0x3FFF
        sc = torch.as_tensor(limbs.view(np.int32), device=dev)
        res = {"c": c, "points_s": gen_s, "pippenger": n > SMALL_MSM_LANES}
        sums = {}
        for name, affine in (("projective", False), ("affine", True)):
            t0 = time.time()
            sums[name] = _affine(msm(sc, pts, affine=affine))
            first_s = time.time() - t0
            iters = 3 if log_n <= 16 else 1
            t0 = time.time()
            for _ in range(iters):
                r = msm(sc, pts, affine=affine)
            _sync(dev)
            dt = (time.time() - t0) / iters
            del r
            res[name] = {"first_call_s": first_s, "ms": dt * 1e3,
                         "points_per_s": n / dt}
            log(f"n=2^{log_n} {name}: {n / dt:,.0f} pts/s ({dt * 1e3:.1f} "
                f"ms/msm, first call {first_s:.1f}s)")
        res["equal"] = sums["projective"] == sums["affine"]
        log(f"n=2^{log_n}: affine sum equals projective = {res['equal']}")
        out["sizes"][log_n] = res
        del pts, sc
    out["ok"] = all(r["equal"] for r in out["sizes"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("logs", nargs="*", type=int, default=[12, 16])
    args = ap.parse_args(argv)
    resolve(CUDA)
    print(nvidia_smi(), flush=True)
    out = run(args.logs, log=lambda m: print(m, flush=True))
    print("ALL OK" if out["ok"] else "MISMATCH", flush=True)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
