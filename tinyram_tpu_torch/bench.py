"""Throughput and proof benchmark of the port on one card: the twin of
`bench.py`.

Usage: python -m tinyram_tpu_torch.bench [--device cuda] [--log-msm 16]
           [--log-msm2 20] [--log-modmul 18] [--log-ntt 20] [--log-ntt-b 18]
           [--ntt-cols 16] [--iters 5] [--no-prove]

Measures what the JAX `bench.py` measures, at its sizes and with its
inputs (`np.random.default_rng(1)` drawn in its step order for the MSM
scalars and the modmul operands, 2 and 3 for the NTTs; top limb masked
with 0x3FFF):

- `msm_points_per_s`: `msm` over the 2^log_msm generators of
  `setup(log_msm)` (hashed in the spawned pool of `ipa/srs.py`, cached in
  `build/cache/`), then `msm2_points_per_s` at 2^log_msm2;
- `modmul_per_s`: `FP.mul` at (16, 2^log_modmul), kernel B1 on the card;
- `ntt_elems_per_s` (one column of 2^log_ntt) and
  `ntt_batched_elems_per_s` (ntt_cols x 2^log_ntt_b), kernel B2 four-step;

and adds what the port's users pay per proof (unless `--no-prove`):
`prove_s_config2`, `prove_s_config3`: one cold proof, then `WARM_PROOFS`
warm proofs in the same process through `tinyram/prove_config.py`, with
the peak device memory of each.

Each throughput is the median, min and max over `--iters` samples after one
warm-up call (the MSM's warm-up checks the affine-input precondition,
outside the timed samples); a sample is the wall time of one call between
two `torch.cuda.synchronize()`, or of `MODMUL_BATCH` back-to-back
products for the modmul (one product's kernel takes ~20 us, about the
host's time to launch it).  Nothing is read from earlier runs or other devices.

Prints ONE JSON line (under 1,500 characters) on stdout; progress goes to
stderr, and the results so far, with each step's kernel launches per call,
to `build/bench_partial.json` after every step.  A step that raises is
recorded under "errors" by its name and the process exits 1 after the
line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from . import kernels
from .field import FP
from .ipa.srs import CACHE_DIR, ROOT
from .utils.device import resolve

PARTIAL = os.path.join(ROOT, "build", "bench_partial.json")
MODMUL_BATCH = 64  # back-to-back products per modmul sample
WARM_PROOFS = 3  # warm proofs after the cold one, per configuration


def _limbs(rng, shape) -> np.ndarray:
    """Canonical field elements (< 2^254) as uint32 limbs, as `bench.py`
    draws them."""
    limbs = rng.integers(0, 1 << 16, size=(16,) + tuple(shape)).astype(np.uint32)
    limbs[15] &= 0x3FFF
    return limbs


def _tensor(limbs: np.ndarray, dev) -> torch.Tensor:
    return torch.as_tensor(limbs.view(np.int32), device=dev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _spread(xs, digits=None) -> dict:
    """Median, min and max, rounded to `digits` (None: to integers)."""
    return {"med": round(statistics.median(xs), digits),
            "min": round(min(xs), digits), "max": round(max(xs), digits)}


class Bench:
    """The steps on one device; `results` holds each step's numbers (and
    its launches per call), `errors` the steps that raised."""

    def __init__(self, device, iters: int = 5, log=None):
        self.dev = resolve(device)
        self.iters = iters
        self.log = log or (lambda m: print(m, file=sys.stderr, flush=True))
        self.rng = np.random.default_rng(1)  # bench.py's shared draw
        self.results: dict = {}
        self.errors: dict = {}

    # ------------------------------------------------------------ harness

    def _samples(self, fn, batch: int = 1, warmup=None) -> tuple[list, dict]:
        """Seconds of `iters` samples of `batch` calls after one warm-up
        call (`warmup`, or fn), and the kernel launches of one call."""
        (warmup or fn)()
        _sync(self.dev)
        before = kernels.launch_counts()
        secs = []
        for _ in range(self.iters):
            t0 = time.perf_counter()
            for _ in range(batch):
                fn()
            _sync(self.dev)
            secs.append((time.perf_counter() - t0) / batch)
        calls = self.iters * batch
        launches = {k: (v - before[k]) // calls
                    for k, v in kernels.launch_counts().items() if v > before[k]}
        return secs, launches

    def _rate(self, name, fn, work: int, batch: int = 1, warmup=None,
              **info) -> None:
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        secs, launches = self._samples(fn, batch, warmup)
        out = {**info, **_spread([work / s for s in secs])}
        if self.dev.type == "cuda":
            out["peak_gib"] = round(torch.cuda.max_memory_allocated(self.dev)
                                    / 2**30, 2)
        self.results[name] = {**out, "seconds": secs, "launches": launches}
        self.log(f"[bench] {name}: {out}; launches per call {launches}")

    def step(self, name, fn) -> None:
        """Run one step; an exception is recorded under its name (with the
        traceback on stderr) and the other steps go on."""
        t0 = time.time()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - recorded, and the exit code is 1
            traceback.print_exc()
            self.errors[name] = f"{type(e).__name__}: {e}"[:160]
        self.log(f"[bench] step {name}: {time.time() - t0:.2f}s")
        os.makedirs(os.path.dirname(PARTIAL), exist_ok=True)
        with open(PARTIAL, "w") as f:
            json.dump({"results": self.results, "errors": self.errors}, f,
                      indent=1)

    # -------------------------------------------------------------- steps

    def msm(self, name: str, log_n: int) -> None:
        from .curve.msm import choose_window_bits, msm
        from .ipa import setup

        n = 1 << log_n
        t0 = time.time()
        srs = setup(log_n, self.dev, cache_dir=CACHE_DIR)
        setup_s = time.time() - t0
        sc = _tensor(_limbs(self.rng, (n,)), self.dev)
        self._rate(name, lambda: msm(sc, srs.g), n,
                   warmup=lambda: msm(sc, srs.g, check_affine=True),
                   n=f"2^{log_n}",
                   c=choose_window_bits(n) if n > 1 << 15 else None)
        self.results[name]["setup_s"] = setup_s

    def modmul(self, log_n: int) -> None:
        n = 1 << log_n
        limbs = self.rng.integers(0, 1 << 16, size=(2, 16, n)).astype(np.uint32)
        limbs[:, 15] &= 0x3FFF
        a, b = _tensor(limbs[0], self.dev), _tensor(limbs[1], self.dev)
        self._rate("modmul_per_s", lambda: FP.mul(a, b), n, MODMUL_BATCH,
                   n=f"2^{log_n}")

    def ntt(self, log_n: int) -> None:
        from .poly import ntt

        c = _tensor(_limbs(np.random.default_rng(2), (1 << log_n,)), self.dev)
        self._rate("ntt_elems_per_s", lambda: ntt(FP, c), 1 << log_n,
                   n=f"2^{log_n}")

    def ntt_batched(self, log_n: int, cols: int) -> None:
        from .poly import ntt

        c = _tensor(_limbs(np.random.default_rng(3), (cols, 1 << log_n)),
                    self.dev)
        self._rate("ntt_batched_elems_per_s", lambda: ntt(FP, c),
                   cols << log_n, shape=f"{cols}x2^{log_n}")

    def prove(self, config: int) -> None:
        """One cold proof and `WARM_PROOFS` warm ones of BASELINE config
        `config` (`prove_config`, no mock); seconds and peak GiB of each."""
        from .tinyram.prove_config import prove_config

        rep = prove_config(config, mock=False, device=self.dev,
                           cache_dir=CACHE_DIR, warm=WARM_PROOFS, log=self.log)
        rep.pop("objects")
        out = {"k": rep["k"], "cold": round(rep["seconds"]["prove"], 3),
               **_spread(rep["warm_prove_s"], digits=3)}
        peaks = rep["peak_bytes"]  # empty off the card
        if peaks:
            out["peak_gib"] = round(peaks["prove"] / 2**30, 2)
            out["warm_peak_gib"] = round(max(
                peaks[f"prove warm {i + 1}"] for i in range(WARM_PROOFS))
                / 2**30, 2)
        self.results[f"prove_s_config{config}"] = {
            **out, "warm_s": rep["warm_prove_s"], "peak_bytes": peaks,
            "seconds": rep["seconds"], "launches": rep["launches"]}
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def throughput(self, log_msm=16, log_msm2=20, log_modmul=18, log_ntt=20,
                   log_ntt_b=18, ntt_cols=16) -> None:
        """The JAX bench's steps in its order (it draws its shared MSM and
        modmul inputs in that order); the large MSM last."""
        self.step("msm_points_per_s", lambda: self.msm("msm_points_per_s",
                                                       log_msm))
        self.step("modmul_per_s", lambda: self.modmul(log_modmul))
        self.step("ntt_elems_per_s", lambda: self.ntt(log_ntt))
        self.step("ntt_batched_elems_per_s",
                  lambda: self.ntt_batched(log_ntt_b, ntt_cols))
        self.step("msm2_points_per_s", lambda: self.msm("msm2_points_per_s",
                                                        log_msm2))

    def line(self, device_name: str) -> str:
        """The one JSON line: each step's summary, without its samples
        and launches."""
        drop = ("seconds", "launches", "setup_s", "warm_s", "peak_bytes")
        out = {"bench": "tinyram_tpu_torch", "device": device_name,
               "torch": torch.__version__, "iters": self.iters}
        for name, res in self.results.items():
            out[name] = {k: v for k, v in res.items() if k not in drop}
        out["errors"] = self.errors
        return json.dumps(out, separators=(",", ":"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-msm", type=int, default=16)
    ap.add_argument("--log-msm2", type=int, default=20)
    ap.add_argument("--log-modmul", type=int, default=18)
    ap.add_argument("--log-ntt", type=int, default=20)
    ap.add_argument("--log-ntt-b", type=int, default=18)
    ap.add_argument("--ntt-cols", type=int, default=16)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--no-prove", action="store_true")
    args = ap.parse_args(argv)
    bench = Bench(args.device, args.iters)
    if bench.dev.type == "cuda":
        from .probes import nvidia_smi

        device_name = nvidia_smi()
    else:
        device_name = str(bench.dev)
    bench.throughput(args.log_msm, args.log_msm2, args.log_modmul,
                     args.log_ntt, args.log_ntt_b, args.ntt_cols)
    if not args.no_prove:
        for config in (2, 3):
            bench.step(f"prove_s_config{config}",
                       lambda c=config: bench.prove(c))
    print(bench.line(device_name), flush=True)
    return 1 if bench.errors else 0


if __name__ == "__main__":
    sys.exit(main())
