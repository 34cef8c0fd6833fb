"""Sweep of the port's point kernels on the GPU.

Usage: python scripts/torch_point_sweep.py [--root CHECKOUT] [--out FILE]

Times the one-step B3 (`padd_select_mixed`) and B5 (`padd_select`) at 2^15
lanes with 0 %, 5 %, 50 % and 100 % of the mask set, and B5 at 50 % on
2^17 lanes; the one-step B4 (`padd`) and B6 (`pdouble`) at 2^15 lanes and
at 1280 (config 2's 20 windows of 64 MSM columns), and, where the checkout
has B6 with a count, 12 doublings at 1280 lanes in one launch beside the
loop of 12 one-step launches.  Then, where the checkout has them, the
bucket scan B3s (L = 128 steps at 2^15 lanes), the ladder B5l (R = 256
bits, half set, at 2^15 lanes), the suffix scan B4s (S = 64 steps at
20 x 64 x 64 lanes) and the window combine B6h (20 windows of c = 13 at 4
and 64 lanes, one thread or a group of four per lane, and at one lane with
one thread: the latency of its chain of dependent products).  Each as
CUDA-graph replays (`probes.device_ms`) and as the same launches issued
from Python.  The inputs are random canonical field elements: the
formulas' cost does not depend on whether a point is on the curve.
`--root` imports `tinyram_tpu_torch` from another checkout (an unpacked
parent commit, say), so two versions can be timed in one call.  Prints the
card's name and power limit first.  Needs a CUDA device; without one it
exits 1.

`chip_smoke.py` runs the same sweep, and times the four forms against the
Python loops of one-step launches below (`scan_loop`, `ladder_loop`,
`suffix_loop`, `horner_loop`) on config 2's bucket-scan mask
(`bucket_same`).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHARES = (0.0, 0.05, 0.5, 1.0)


def _limbs(gen, n, device):
    import numpy as np
    import torch

    limbs = gen.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    limbs[15] &= 0x3FFF
    return torch.as_tensor(limbs.astype(np.int32), device=device)


def sweep(dev, cp, device_ms, seed: int = 0) -> list[dict]:
    """[{kernel, lanes, share, ms, ms_issued}] of the one-step B3 and B5."""
    import numpy as np
    import torch

    from tinyram_tpu_torch.curve.vesta import PointBatch

    gen = np.random.default_rng(seed)
    rows = []
    for lanes, shares, kids in (((1 << 15), SHARES, ("B3", "B5")),
                                ((1 << 17), (0.5,), ("B5",))):
        p = PointBatch(*(_limbs(gen, lanes, dev) for _ in range(3)))
        q = PointBatch(*(_limbs(gen, lanes, dev) for _ in range(3)))
        for share in shares:
            mask = torch.as_tensor(gen.random(lanes) < share, device=dev)
            for kid in kids:
                fn = ((lambda: cp.padd_select_mixed(mask, p, q.x, q.y))
                      if kid == "B3" else (lambda: cp.padd_select(mask, p, q)))
                rows.append({"kernel": kid, "lanes": lanes, "share": share,
                             "ms": device_ms(fn, 50),
                             "ms_issued": device_ms(fn, 50, graph=False)})
                print(f"[sweep] {kid} lanes=2^{lanes.bit_length() - 1} "
                      f"mask {100 * share:5.1f} %: {rows[-1]['ms']:.4f} ms "
                      f"graph, {rows[-1]['ms_issued']:.4f} ms issued",
                      flush=True)
    return rows


def _points(gen, shape, dev):
    from tinyram_tpu_torch.curve.vesta import PointBatch

    n = 1
    for d in shape:
        n *= d
    return PointBatch(*(_limbs(gen, n, dev).reshape((16,) + tuple(shape))
                        for _ in range(3)))


def _row(rows, tag, kernel, fn, reps, device_ms, **shape):
    rows.append({"kernel": kernel, **shape, "ms": device_ms(fn, reps),
                 "ms_issued": device_ms(fn, reps, graph=False)})
    print(f"[{tag}] {kernel} {shape}: {rows[-1]['ms']:.4f} ms graph, "
          f"{rows[-1]['ms_issued']:.4f} ms issued", flush=True)


def onestep(dev, cp, device_ms, seed: int = 2) -> list[dict]:
    """[{kernel, lanes, times, ms, ms_issued}] of the one-step B4 and B6 at
    2^15 and 1280 lanes, and of 12 doublings at 1280 lanes: B6 with a count
    where the checkout has it, and the loop of one-step launches."""
    import numpy as np

    gen = np.random.default_rng(seed)
    rows = []
    for lanes in (1 << 15, 20 * 64):
        p, q = _points(gen, (lanes,), dev), _points(gen, (lanes,), dev)
        _row(rows, "onestep", "B4", lambda: cp.padd(p, q), 50, device_ms,
             lanes=lanes, times=1)
        _row(rows, "onestep", "B6", lambda: cp.pdouble(p), 50, device_ms,
             lanes=lanes, times=1)
    _row(rows, "onestep", "B6 loop", lambda: doubling_loop(cp, p, 12), 5,
         device_ms, lanes=lanes, times=12)
    if "times" in inspect.signature(cp.pdouble).parameters:
        _row(rows, "onestep", "B6", lambda: cp.pdouble(p, times=12), 20,
             device_ms, lanes=lanes, times=12)
    return rows


def forms(dev, cp, device_ms, seed: int = 1, L: int = 128,
          lanes: int = 1 << 15, R: int = 256) -> list[dict]:
    """[{kernel, ms, ms_issued}] of B3s, B5l and, where the checkout has
    them, B4s and B6h at config 2's shapes."""
    import numpy as np
    import torch

    gen = np.random.default_rng(seed)
    same = bucket_same(gen, L, lanes, device=dev)
    sx, sy = (_limbs(gen, L * lanes, dev).reshape(16, L, lanes).transpose(0, 1)
              .contiguous() for _ in range(2))
    bits = torch.as_tensor(gen.random((R, lanes)) < 0.5, device=dev)
    p = _points(gen, (lanes,), dev)
    rows = []
    _row(rows, "forms", "B3s", lambda: cp.padd_select_mixed_scan(same, sx, sy),
         2, device_ms)
    _row(rows, "forms", "B5l", lambda: cp.padd_select_ladder(bits, p), 2,
         device_ms)
    if not hasattr(cp, "pdouble_horner"):
        return rows
    b = _points(gen, (20 * 64, 64, 64), dev)
    _row(rows, "forms", "B4s", lambda: cp.padd_suffix_scan(b), 2, device_ms,
         lanes=20 * 64 * 64, steps=64)
    for cols in (4, 64):
        ws = _points(gen, (20, cols), dev)
        for group in (1, 4):
            _row(rows, "forms", "B6h", lambda: cp.pdouble_horner(ws, 13, group),
                 3, device_ms, lanes=cols, group=group)
    one = _points(gen, (20, 1), dev)
    _row(rows, "forms", "B6h", lambda: cp.pdouble_horner(one, 13, 1), 3,
         device_ms, lanes=1, group=1)
    return rows


def bucket_same(gen, L: int, M: int, lanes_per_window: int = 128,
                c: int = 13, device="cpu"):
    """The (L, M) `same` mask of config 2's bucket scan (`msm.py`
    `_group_bucket_sums`): per window, L * lanes_per_window sorted random
    bucket ids |d| in [0, 2^(c-1)], cut into chunks of L; same[s, m] says
    that chunk m's step s continues step s-1's bucket."""
    import numpy as np
    import torch

    windows = M // lanes_per_window
    d = np.sort(gen.integers(0, (1 << (c - 1)) + 1,
                             size=(windows, lanes_per_window * L)), axis=1)
    chunk = d.reshape(M, L)
    same = np.zeros((M, L), dtype=bool)
    same[:, 1:] = chunk[:, 1:] == chunk[:, :-1]
    return torch.as_tensor(np.ascontiguousarray(same.T), device=device)


def scan_loop(cp, same, sx, sy, ident):
    """The Python loop of one-step B3 launches that B3s replaces (the bucket
    scan as `msm.py` ran it before the scan form), from `ident`, the
    identity batch (made outside, so that a CUDA graph can capture this)."""
    import torch

    L, n_limbs, M = sx.shape
    ys = [torch.empty((L, n_limbs, M), dtype=torch.int32, device=sx.device)
          for _ in range(3)]
    acc = ident
    for s in range(L):
        acc = cp.padd_select_mixed(same[s], acc, sx[s], sy[s])
        for coord, val in zip(ys, acc):
            coord[s] = val
    return ys


def ladder_loop(cp, bits, p, ident):
    """The Python loop of one-step B6 and B5 launches that B5l replaces,
    from `ident`, the identity batch."""
    acc = ident
    for bit in bits:
        acc = cp.padd_select(bit, p, cp.pdouble(acc))
    return acc


def doubling_loop(cp, p, times):
    """The Python loop of one-step B6 launches that B6 with a count
    replaces."""
    for _ in range(times):
        p = cp.pdouble(p)
    return p


def suffix_loop(cp, b, ident, take):
    """The Python loop of one-step B4 and B5 launches that B4s replaces
    (the weighted reduce's suffix scan as `msm.py` ran it before), over b
    of batch (n, S), from `ident` (batch (n,)) and the all-true `take`."""
    from tinyram_tpu_torch.curve.vesta import PointBatch

    acc = tot = ident
    for j in range(b.x.shape[-1] - 1, -1, -1):
        acc = cp.padd(acc, PointBatch(*(c[..., j] for c in b)))
        if j >= 1:
            tot = cp.padd_select(take, acc, tot)
    return acc, tot


def horner_loop(cp, ws, c, ident):
    """The Python loop of one-step B6 and B4 launches that B6h replaces,
    over window sums of batch (nw, n), from `ident` (batch (n,))."""
    from tinyram_tpu_torch.curve.vesta import PointBatch

    acc = ident
    for w in range(ws.x.shape[1] - 1, -1, -1):
        for _ in range(c):
            acc = cp.pdouble(acc)
        acc = cp.padd(acc, PointBatch(*(coord[:, w] for coord in ws)))
    return acc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose tinyram_tpu_torch is measured")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "point_sweep.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_point_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from tinyram_tpu_torch import probes
    from tinyram_tpu_torch.curve import cuda_point as cp

    smi = probes.nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    out = {"nvidia_smi": smi, "root": os.path.abspath(args.root),
           "sweep": sweep(dev, cp, probes.device_ms),
           "onestep": onestep(dev, cp, probes.device_ms)}
    if hasattr(cp, "padd_select_ladder"):
        out["forms"] = forms(dev, cp, probes.device_ms)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k in ("sweep", "onestep", "forms")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
