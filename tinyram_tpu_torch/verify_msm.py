"""The MSM's public entry points on adversarial scalars, against host
references: the port's twin of `scripts/verify_msm_tpu.py`.

Usage: python -m tinyram_tpu_torch.verify_msm [log_n=8] [--device cpu]

`msm` and `msm_many` (3 columns) run with `check_affine=True` over the
2^log_n generators of `setup(log_n)` (hashed in the spawned pool of
`ipa/srs.py` and cached in `build/cache/`) on the JAX script's four scalar
cases: random; edge (0, 1, p - 1, 2, then random); all-equal (every lane
of every window falls into one bucket: the carry fixup's longest chain);
and selector-like (0/1).  Results are compared in affine form with:

- "oracle": `curve/host_jacobian.py` `lincomb` (one inversion per linear
  combination, not one per step as `curve/host.py` `msm` takes).  The
  all-equal case is s · ΣP, the selector-like one the sum of the selected
  points; the combinations of all cases are split into chunks over one
  spawned pool and each case's partial sums added.
- "halves c=13": past `ORACLE_MAX` points the random and edge cases would
  cost minutes of host big-int arithmetic, so each is held against the sum
  of the MSMs of its two halves at `window_bits=13` (another window width,
  plan and bucket layout than the whole MSM's).

Prints one line per case and per `msm_many` run with the check used, then
"ALL OK" or "FAILURES PRESENT"; exits 1 on any mismatch.
"""

from __future__ import annotations

import argparse
import random
import sys
import time

import torch

from .curve import PointBatch, to_affine_host
from .curve import host_jacobian
from .curve.msm import msm, msm_many
from .field import FP
from .ipa.srs import CACHE_DIR, pool_map, setup
from .utils.device import CUDA, resolve

SKEW = 123456789  # the all-equal scalar of the JAX script
ORACLE_MAX = 1 << 16  # past this many points, random cases use the halves
HALF_WINDOW_BITS = 13
POOL_MIN = 1 << 12  # smaller host combinations run in this process
_POOL_CHUNK = 1 << 12
MANY_COLUMNS = ("random", "edge", "tiny(selector-like)")


def cases(n: int) -> dict[str, list[int]]:
    """The JAX script's four scalar vectors of length n (>= 4), drawn from
    `random.Random(1)` in its order."""
    rng = random.Random(1)
    p = FP.modulus
    return {
        "random": [rng.randrange(p) for _ in range(n)],
        "edge": [0, 1, p - 1, 2] + [rng.randrange(p) for _ in range(n - 4)],
        "skew(all-equal)": [SKEW] * n,
        "tiny(selector-like)": [rng.randrange(2) for _ in range(n)],
    }


def _lincomb_part(scalars, points):
    return host_jacobian.lincomb(zip(scalars, points))


def _terms(scalars, points):
    """(scalars, points, factor) of the host combination behind a case:
    s · ΣP for all-equal scalars, the selected points for 0/1 scalars,
    else Σ s_i·P_i itself (factor 1)."""
    if len(set(scalars)) == 1:
        return [1] * len(points), points, scalars[0]
    if set(scalars) <= {0, 1}:
        picked = [p for s, p in zip(scalars, points) if s]
        return [1] * len(picked), picked, 1
    return scalars, points, 1


def oracles(vectors: dict, points) -> dict:
    """name -> the affine host reference of each scalar vector against
    `points`: the combinations of every case, cut into chunks, run in one
    spawned pool (in this process below `POOL_MIN` terms in all) and each
    case's partial sums are added."""
    jobs, factors = [], {}
    for name, scalars in vectors.items():
        sc, pts, factors[name] = _terms(scalars, points)
        jobs += [(name, sc[i:i + _POOL_CHUNK], pts[i:i + _POOL_CHUNK])
                 for i in range(0, len(sc), _POOL_CHUNK)]
    if sum(len(sc) for _, sc, _ in jobs) < POOL_MIN:
        parts = [_lincomb_part(sc, pts) for _, sc, pts in jobs]
    else:
        parts = pool_map(_lincomb_part, [j[1] for j in jobs],
                         [j[2] for j in jobs])
    return {name: host_jacobian.scalar_mul(factors[name], host_jacobian.lincomb(
        (1, part) for (owner, _, _), part in zip(jobs, parts) if owner == name))
        for name in vectors}


def _affine(p: PointBatch):
    """A single device point (batch ()) as a host affine point."""
    return to_affine_host(PointBatch(*(c[:, None] for c in p)))[0]


def halves(sc: torch.Tensor, g: PointBatch):
    """The sum of the MSMs of the two halves of (sc, g) at
    `window_bits=HALF_WINDOW_BITS`, affine."""
    h = sc.shape[-1] // 2
    parts = [msm(sc[:, s], PointBatch(*(c[:, s] for c in g)),
                 window_bits=HALF_WINDOW_BITS)
             for s in (slice(0, h), slice(h, None))]
    return host_jacobian.lincomb((1, _affine(p)) for p in parts)


def run(log_n: int, device=CUDA, log=print) -> dict:
    """Every case at n = 2^log_n on `device`; returns {"ok", "cases":
    {name: {"ok", "check", "msm_s", "halves_s"}}, "oracle_s", "msm_many":
    {...}}.  Seconds are wall times; the device has finished at each (the
    results are read back)."""
    dev = resolve(device)
    n = 1 << log_n
    t0 = time.time()
    srs = setup(log_n, dev, cache_dir=CACHE_DIR)
    out = {"log_n": log_n, "setup_s": time.time() - t0, "cases": {}}
    vectors = cases(n)
    sc, got, msm_s = {}, {}, {}
    for name, scalars in vectors.items():
        sc[name] = FP.encode(scalars, to_mont=False, device=dev)
        t0 = time.time()
        got[name] = _affine(msm(sc[name], srs.g, check_affine=True))
        msm_s[name] = time.time() - t0
    by_halves = [name for name in ("random", "edge") if n > ORACLE_MAX]
    t0 = time.time()
    refs = oracles({k: v for k, v in vectors.items() if k not in by_halves},
                   srs.g_host)
    out["oracle_s"] = time.time() - t0
    reference_s = {}
    for name in by_halves:
        t0 = time.time()
        refs[name] = halves(sc[name], srs.g)
        reference_s[name] = time.time() - t0
    for name in vectors:
        check = f"halves c={HALF_WINDOW_BITS}" if name in by_halves else "oracle"
        ok = got[name] == refs[name]
        out["cases"][name] = {"ok": ok, "check": check, "msm_s": msm_s[name],
                              "halves_s": reference_s.get(name)}
        log(f"msm[{name:>20s}] n=2^{log_n}: {'OK' if ok else 'MISMATCH'} "
            f"({check}; msm {msm_s[name]:.2f}s)")
    log(f"host oracle of {len(vectors) - len(by_halves)} cases: "
        f"{out['oracle_s']:.2f}s")
    many = torch.stack([sc[c] for c in MANY_COLUMNS], dim=1)
    t0 = time.time()
    same = to_affine_host(msm_many(many, srs.g, check_affine=True)) == \
        [refs[c] for c in MANY_COLUMNS]
    many_s = time.time() - t0
    out["msm_many"] = {"ok": same, "columns": list(MANY_COLUMNS),
                       "check": "the single cases' references", "msm_s": many_s}
    log(f"msm_many[{len(MANY_COLUMNS)} cols] n=2^{log_n}: "
        f"{'OK' if same else 'MISMATCH'} ({many_s:.2f}s)")
    out["ok"] = same and all(c["ok"] for c in out["cases"].values())
    log("ALL OK" if out["ok"] else "FAILURES PRESENT")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    if dev.type == "cuda":
        from .probes import nvidia_smi

        print(nvidia_smi(), flush=True)
    print(f"device: {dev}", flush=True)
    return 0 if run(args.log_n, dev, log=lambda m: print(m, flush=True))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
