#!/usr/bin/env python3
"""BASELINE config 4 (2^20 steps of the full ISA, W = 24, k = 21) through
the PyTorch port, stage by stage: the twin of scripts/prove_config4.py
(its stages and flags).

Usage: python3 scripts/torch_prove_config4.py [--mock] [--prove]
           [--device cuda|cpu] [--k K] [--word-bits W] [--out PATH]
           [steps_log2=20]

1. Emulates 2^steps_log2 steps with the Python and the native emulator
   (equal traces required) and builds the witness on the device;
2. --mock: the port's MockProver on that witness (any failure raises);
3. --prove: setup(k) (cached in build/cache/), keygen (the key is not
   cached: its Lagrange columns rest on the host), create_proof, verify,
   and answer + 1 rejected.

Everything runs through `tinyram.prove_config.prove_config(4,
frugal=True)`, at config 4's sizing (`prove_config.SIZING[4]`): the
witness in pinned host memory (~40 GiB beside the process's own ~23 GiB),
brought to the card a chunk at a time; transforms and MSMs of two
columns, gate slabs of 8; the quotient lifted one coset at a time (its
whole lift would not fit).  Free device blocks are returned
after each stage and the verifier's instance cache is emptied after each
verification.  The record (default chiprun_out/config4_report.json) is
written when the run starts and again as each stage ends: each finished
stage's seconds, peak and held GiB of device memory; the host's MemTotal
(/proc/meminfo), the process's peak RSS and the pinned host memory the
card's allocator holds; the card's name and power limit; the circuit's
sizes and sizing;
and, when a stage raises (the card's OutOfMemoryError, the host's
MemoryError or any other), the stage that stopped, its exception's type
and first line and the device memory at that moment.  A stopped run exits
1; no later stage runs and nothing moves to another device.

On the CPU the mock is attempted only where MemTotal exceeds 1.2 times its
estimate (config 3's 8.96 GiB on the card, scaled by the rows); otherwise
the record says that it was not attempted, and why, and the run goes on.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "config4_report.json")
MOCK_BYTES_K17 = 8.96 * 2**30  # config 3's mock peak on the card (PERF.md)
MOCK_MARGIN = 1.2


def mem_total_bytes() -> int | None:
    """MemTotal of /proc/meminfo in bytes (None where it cannot be read)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def peak_rss_bytes() -> dict:
    """The peak resident set of this process and of its waited-for
    children (the SRS pool), in bytes."""
    return {who: resource.getrusage(flag).ru_maxrss * 1024 for who, flag in (
        ("self", resource.RUSAGE_SELF), ("children", resource.RUSAGE_CHILDREN))}


def gib(b):
    return None if b is None else b / 2**30


class Record:
    """The report, rewritten to `path` on every change."""

    def __init__(self, path: str, device, base: dict):
        self.path = path
        self.device = device
        self.data = dict(base, stages={}, stopped=None)
        self.write()

    def write(self) -> None:
        self.data["mem_total_gib"] = gib(mem_total_bytes())
        self.data["pinned_gib"] = self.pinned()
        self.data["peak_rss_gib"] = {k: gib(v)
                                     for k, v in peak_rss_bytes().items()}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=1)
        os.replace(tmp, self.path)

    def pinned(self) -> dict | None:
        """The current and peak pinned host memory of the card's host
        allocator (None off the card or where torch does not report it)."""
        import torch

        stats = getattr(torch.cuda, "host_memory_stats", None)
        if self.device.type != "cuda" or stats is None:
            return None
        st = stats()
        return {k: gib(st.get(f"allocated_bytes.{k}"))
                for k in ("current", "peak")}

    def device_memory(self) -> dict | None:
        import torch

        if self.device.type != "cuda":
            return None
        free, total = torch.cuda.mem_get_info(self.device)
        return {"allocated_gib": gib(torch.cuda.memory_allocated(self.device)),
                "reserved_gib": gib(torch.cuda.memory_reserved(self.device)),
                "free_gib": gib(free), "total_gib": gib(total)}

    def on_stage(self, name, seconds, peak, held, error) -> None:
        if error is None:
            self.data["stages"][name] = {"seconds": seconds,
                                         "peak_gib": gib(peak),
                                         "held_gib": gib(held)}
        else:
            text = str(error).strip()
            self.data["stopped"] = {
                "stage": name, "seconds": seconds,
                "error_type": type(error).__name__,
                "error": text.splitlines()[0] if text else "",
                "peak_gib": gib(peak), "device_memory": self.device_memory()}
        self.write()


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps_log2", type=int, nargs="?", default=20)
    ap.add_argument("--mock", action="store_true")
    ap.add_argument("--prove", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--word-bits", type=int, default=24)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import torch

    from tinyram_tpu_torch.tinyram.circuit import TinyRamCircuit
    from tinyram_tpu_torch.tinyram.prove_config import REG_COUNT, prove_config
    from tinyram_tpu_torch.utils.device import resolve

    dev = resolve(args.device)
    smi = None
    if dev.type == "cuda":
        from tinyram_tpu_torch.probes import nvidia_smi

        smi = nvidia_smi()
        print(smi, flush=True)
    cs = TinyRamCircuit(args.word_bits, REG_COUNT, k=args.k).tcs.cs
    sizes = {"steps_log2": args.steps_log2, "word_bits": args.word_bits,
             "k": args.k, "n": 1 << args.k, "advice": cs.num_advice,
             "fixed": cs.num_fixed, "instance": cs.num_instance,
             "lookups": len(cs.lookups), "range_lookups": len(cs.range_lookups)}
    mock = args.mock
    not_attempted = {}
    estimate = MOCK_BYTES_K17 * 2.0 ** (args.k - 17)
    total = mem_total_bytes()
    if mock and dev.type == "cpu" and (total is None
                                       or total < MOCK_MARGIN * estimate):
        mock = False
        not_attempted["mock"] = (
            f"MemTotal {gib(total)} GiB is below {MOCK_MARGIN} x the mock's "
            f"estimate of {gib(estimate):.1f} GiB (config 3's 8.96 GiB on "
            f"the card x 2^{args.k - 17})")
        print(f"[config4] mock not attempted: {not_attempted['mock']}",
              flush=True)
    rec = Record(args.out, dev, {
        "config": 4, "argv": sys.argv[1:] if argv is None else list(argv),
        "device": str(dev), "device_name": (torch.cuda.get_device_name(dev)
                                            if dev.type == "cuda" else None),
        "nvidia_smi": smi, "sizes": sizes, "not_attempted": not_attempted})
    t0 = time.time()
    try:
        report = prove_config(4, args.steps_log2, mock=mock, prove=args.prove,
                              device=dev, word_bits=args.word_bits, k=args.k,
                              log=lambda m: print(m, flush=True),
                              on_stage=rec.on_stage, frugal=True)
    except Exception as e:  # the record names the stage; the run stops
        if rec.data["stopped"] is None:  # raised between two stages
            text = str(e).strip()
            rec.data["stopped"] = {
                "stage": None, "error_type": type(e).__name__,
                "error": text.splitlines()[0] if text else "",
                "device_memory": rec.device_memory()}
        rec.data["total_s"] = time.time() - t0
        rec.write()
        print(f"[config4] stopped in {rec.data['stopped']['stage']}: "
              f"{rec.data['stopped']['error_type']}: "
              f"{rec.data['stopped']['error']}", flush=True)
        print(json.dumps(rec.data), flush=True)
        return 1
    report.pop("objects")
    rec.data["total_s"] = time.time() - t0
    rec.data["sizes"].update(steps=report["steps"], accesses=report["accesses"])
    for key in ("sizing", "mock_failures", "proof_bytes", "phases",
                "verifier_phases", "launches", "widest_launches"):
        if key in report:
            rec.data[key] = report[key]
    if "instance_cache_held" in report:
        rec.data["instance_cache_held_gib"] = {
            name: {k: gib(v) for k, v in held.items()}
            for name, held in report["instance_cache_held"].items()}
    if "proof_bytes" in report:  # prove_config raised otherwise
        rec.data["verified"] = True
        rec.data["answer_plus_one_rejected"] = True
    rec.write()
    print(json.dumps(rec.data), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
