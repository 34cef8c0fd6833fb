"""Mask-share sweep of the port's select point kernels on the GPU.

Usage: python scripts/torch_point_sweep.py [--root CHECKOUT] [--out FILE]

Times the one-step B3 (`padd_select_mixed`) and B5 (`padd_select`) at 2^15
lanes with 0 %, 5 %, 50 % and 100 % of the mask set, and B5 at 50 % on
2^17 lanes; then, where the checkout has them, the bucket scan B3s (L = 128
steps at 2^15 lanes) and the ladder B5l (R = 256 bits, half set, at 2^15
lanes).  Each as CUDA-graph replays (`probes.device_ms`) and as the same
launches issued from Python.  The inputs are random canonical field elements: the
formulas' cost does not depend on whether a point is on the curve.
`--root` imports `tinyram_tpu_torch` from another checkout (an unpacked
parent commit, say), so two versions can be timed in one call.  Prints the
card's name and power limit first.  Needs a CUDA device; without one it
exits 1.

`chip_smoke.py` runs the same sweep, and times the bucket scan and the
ladder against the Python loops of one-step launches below (`scan_loop`,
`ladder_loop`) on config 2's bucket-scan mask (`bucket_same`).
"""

from __future__ import annotations

import argparse
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


def forms(dev, cp, device_ms, seed: int = 1, L: int = 128,
          lanes: int = 1 << 15, R: int = 256) -> list[dict]:
    """[{kernel, ms, ms_issued}] of B3s and B5l at config 2's shapes."""
    import numpy as np
    import torch

    from tinyram_tpu_torch.curve.vesta import PointBatch

    gen = np.random.default_rng(seed)
    same = bucket_same(gen, L, lanes, device=dev)
    sx, sy = (_limbs(gen, L * lanes, dev).reshape(16, L, lanes).transpose(0, 1)
              .contiguous() for _ in range(2))
    bits = torch.as_tensor(gen.random((R, lanes)) < 0.5, device=dev)
    p = PointBatch(*(_limbs(gen, lanes, dev) for _ in range(3)))
    rows = []
    for kid, fn in (("B3s", lambda: cp.padd_select_mixed_scan(same, sx, sy)),
                    ("B5l", lambda: cp.padd_select_ladder(bits, p))):
        rows.append({"kernel": kid, "ms": device_ms(fn, 2),
                     "ms_issued": device_ms(fn, 2, graph=False)})
        print(f"[forms] {kid}: {rows[-1]['ms']:.4f} ms graph, "
              f"{rows[-1]['ms_issued']:.4f} ms issued", flush=True)
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
           "sweep": sweep(dev, cp, probes.device_ms)}
    if hasattr(cp, "padd_select_ladder"):
        out["forms"] = forms(dev, cp, probes.device_ms)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k in ("sweep", "forms")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
