"""Kernels P1 and P2: op-rate probes of the card's arithmetic units.

Counterpart of the JAX package's two probe scripts:

- P1 replaces the Pallas kernel of `scripts/bench_vpu.py` (`bench`, body
  `make_kernel`): `reps` chained u32 `add`, `mul` or `mulmask`
  (p = x·b; x = (p & 0xFFFF) + (p >> 16), the inner step of a 16-bit-limb
  Montgomery product) per element of a (16, 65536) array, reps 64 and 512.
- P2 replaces the Pallas kernel of `scripts/bench_vpu_ops.py` (`run`, body
  `_kernel_factory`): 256 chained `u32mul`, `u32add`, `u32shift`
  ((x >> 3) ^ b), `f32mul` or `f32fma` (x·b + a) per element of a
  (16384, 128) array.

`vpu_chain` (P1) and `vpu_ops` (P2) take int32 tensors holding u32 bits
(float32 for the f32 ops).  A CUDA tensor goes to `tr_vpu_probe` of
`csrc/vpu_probe.cu`, a CPU tensor to the plain version `chain_plain`, which
works in int64 masked to 32 bits (CPU torch lacks `+`, `-` and `>>` on
uint32).  The f32 chains start in [1, 2) and reach `inf` within 256 steps,
as the JAX script's do; the kernel's `f32fma` rounds once (`fmaf`), the
plain version twice.

Source note (the kernel): one thread per element runs the whole chain in a
register; each step is hidden from the optimiser by an empty `asm volatile`
so no chain folds, and the unrolled kernel holds about `reps` instructions
of the op (`kernels.sass_opcodes`).  An element moves 12 bytes and does
`reps` operations, so at reps >= 16 the probe is bound by the issue rate of
the op's pipe, not by memory: that rate is what it measures.  ptxas merges
two dependent adds into one three-input IADD3 (the empty `asm` acts before
ptxas), so an add chain issues one instruction per two steps.  The integer
multiply rate, set beside the card's 64-lane rate, says how close a long
chain of IMAD comes to the rate that bounds B1-B6.

Run on the card: `python -m tinyram_tpu_torch.probes` prints G ops/s per op
with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from . import kernels
from .utils.device import CUDA, resolve

P1_OPS = ("add", "mul", "mulmask")
P1_REPS = (64, 512)
P1_SHAPE = (16, 65536)
P2_OPS = ("u32mul", "u32add", "u32shift", "f32mul", "f32fma")
P2_REPS = 256
P2_SHAPE = (16384, 128)
F32_OPS = ("f32mul", "f32fma")
REPS = (16, 64, 256, 512)  # the chain lengths the kernel is built for
# op -> tr_vpu_probe's op code
_CODE = {"add": 0, "mul": 1, "mulmask": 2, "u32add": 0, "u32mul": 1,
         "u32shift": 3, "f32mul": 4, "f32fma": 5}
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x·y mod 2^32 for int64 tensors of u32 values, with no product past
    2^48 (so no int64 overflow)."""
    lo = x * (y & 0xFFFF)
    hi = (x * (y >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def chain_plain(op: str, a: torch.Tensor, b: torch.Tensor, reps: int):
    """Plain PyTorch version of P1 and P2: `reps` steps x = op(x, b) from
    x = a."""
    if op in F32_OPS:
        x = a.clone()
        for _ in range(reps):
            x = x * b if op == "f32mul" else x * b + a
        return x
    x = a.to(torch.int64) & _MASK32
    y = b.to(torch.int64) & _MASK32
    for _ in range(reps):
        if op in ("add", "u32add"):
            x = (x + y) & _MASK32
        elif op in ("mul", "u32mul"):
            x = _mul32(x, y)
        elif op == "mulmask":
            p = _mul32(x, y)
            x = (p & 0xFFFF) + (p >> 16)
        else:  # u32shift
            x = (x >> 3) ^ y
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _run(wrapper, op: str, a: torch.Tensor, b: torch.Tensor, reps: int):
    want = torch.float32 if op in F32_OPS else torch.int32
    if a.shape != b.shape or a.dtype != want or b.dtype != want:
        raise TypeError(f"{op}: operands must be two {want} tensors of one "
                        f"shape, got {a.dtype}{tuple(a.shape)} "
                        f"{b.dtype}{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{op}: operands on different devices")
    if reps not in REPS:
        raise ValueError(f"{op}: reps {reps} not in {REPS}")
    if a.device.type == "cpu":
        return chain_plain(op, a, b, reps)
    if a.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {a.device}")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = kernels.library()
    wrapper.launches += 1
    kernels.check(
        lib.tr_vpu_probe(_CODE[op], reps, a.data_ptr(), b.data_ptr(),
                         out.data_ptr(), a.numel(),
                         kernels.stream_ptr(a.device)),
        "tr_vpu_probe",
    )
    return out


def vpu_chain(op: str, a: torch.Tensor, b: torch.Tensor, reps: int):
    """P1's wrapper: `reps` chained u32 `add`, `mul` or `mulmask`."""
    if op not in P1_OPS:
        raise ValueError(f"P1 op {op!r} not in {P1_OPS}")
    return _run(vpu_chain, op, a, b, reps)


def vpu_ops(op: str, a: torch.Tensor, b: torch.Tensor, reps: int = P2_REPS):
    """P2's wrapper: `reps` chained u32 mul/add/shift-xor or f32 mul/fma."""
    if op not in P2_OPS:
        raise ValueError(f"P2 op {op!r} not in {P2_OPS}")
    return _run(vpu_ops, op, a, b, reps)


kernels.register("P1", vpu_chain)
kernels.register("P2", vpu_ops)


# ------------------------------------------------------------- inputs, rates


def p1_inputs(shape=P1_SHAPE, seed: int = 0, device=CUDA):
    """scripts/bench_vpu.py's inputs: a in [0, 2^16), b in [1, 2^16)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, shape).astype(np.int32)
    b = rng.integers(1, 1 << 16, shape).astype(np.int32)
    return torch.as_tensor(a, device=device), torch.as_tensor(b, device=device)


def p2_inputs(op: str, shape=P2_SHAPE, seed: int = 0, device=CUDA):
    """scripts/bench_vpu_ops.py's inputs: u32 in [1, 2^16) or f32 in
    [1, 2), the same array as both operands."""
    rng = np.random.default_rng(seed)
    ui = rng.integers(1, 1 << 16, size=shape).astype(np.int32)
    uf = rng.random(size=shape).astype(np.float32) + 1.0
    arr = torch.as_tensor(uf if op in F32_OPS else ui, device=device)
    return arr, arr.clone()


def cases():
    """(kernel id, wrapper, op, reps) of every probe measurement."""
    out = [("P1", vpu_chain, op, reps) for op in P1_OPS for reps in P1_REPS]
    out += [("P2", vpu_ops, op, P2_REPS) for op in P2_OPS]
    return out


def device_ms(fn, iters: int = 20, graph: bool = True) -> float:
    """Mean device time of one fn() call, after one warm-up (CUDA events).

    With `graph`, `iters` calls are captured in one CUDA graph and its
    replays are timed, so the host's time to issue each launch (the Python
    wrapper and the ctypes call, about as long as a 20 µs kernel) leaves no
    idle gap inside the timed window.  Without it, `iters` calls are timed
    as Python issues them: the way to time a plain version, whose host work
    between its many small launches is part of its cost, and the way to
    see how far the host holds a kernel back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if not graph:
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()  # warm replay
    torch.cuda.synchronize()
    replays = 5
    start.record()
    for _ in range(replays):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def measure(device=CUDA, iters: int = 20) -> list[dict]:
    """Every probe case on the card at the JAX scripts' shapes: its time
    (CUDA graph replays, `device_ms`) and rate in G ops/s (one op = one
    step of one element's chain).  A wrapper counts the launches it issues
    while the graph is captured, not the graph's replays."""
    dev = resolve(device)
    rows = []
    for kid, fn, op, reps in cases():
        a, b = (p1_inputs(device=dev) if kid == "P1"
                else p2_inputs(op, device=dev))
        ms = device_ms(lambda: fn(op, a, b, reps), iters)
        ops = a.numel() * reps
        rows.append({"kernel": kid, "op": op, "reps": reps, "elements":
                     a.numel(), "ms": ms, "gops": ops / (ms * 1e-3) / 1e9})
    return rows


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> int:
    resolve(CUDA)
    print(nvidia_smi(), flush=True)
    rows = measure()
    for r in rows:
        print(f"{r['kernel']} {r['op']:8s} reps={r['reps']:4d}: "
              f"{r['gops']:10.1f} G ops/s  ({r['ms']:.4f} ms)", flush=True)
    print(json.dumps({"probes": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
