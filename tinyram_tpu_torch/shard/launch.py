"""Run a function on a mesh of ranks, one spawned process each.

The JAX package needs no launcher: its mesh lives in one process.  Here
`run_on_mesh(fn, D, *args)` starts D processes with the `spawn` method
(CUDA cannot fork); each joins the process group through a `file://`
rendezvous in a temporary directory of its own (parallel callers never
share a port), builds its `Mesh`, runs `fn(mesh, *args)` and hands its
result back through a file.  `fn` must be a module-level function of this
package (a rank imports it by name, and so imports neither JAX nor a test
module); its arguments and results are pickled, so pass numpy arrays and
Python values, not CUDA tensors.

The parent waits with a deadline: if a rank raises, dies or is still
running at the deadline, the other ranks are stopped and `run_on_mesh`
raises.  Each rank's collectives time out at the same deadline
(`init_process_group(timeout=...)`), so no collective outlives it.  The
CUDA kernels are built in the parent before the ranks start; the ranks
only load them.  On the CPU every rank runs torch on one thread.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import backend_for, make_mesh, rank_devices

TIMEOUT_S = 600.0


class RankError(RuntimeError):
    """A rank raised, died, or ran past the deadline."""


def _rank_main(fn, rank, devices, backend, tmp, timeout_s, args):
    try:
        dev = devices[rank]
        if dev.type == "cpu":
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            rank=rank, world_size=len(devices),
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(make_mesh(len(devices), devices), *args)
        finally:
            dist.destroy_process_group()
        path = os.path.join(tmp, f"result{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    except BaseException:  # the parent raises it, with every rank's traceback
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def describe(devices, backend: str) -> str:
    """One line: the ranks, their devices, the backend and the transport."""
    names = sorted({str(d) for d in devices})
    shared = backend == "gloo" and any(d.type == "cuda" for d in devices)
    return (f"{len(devices)} ranks on {', '.join(names)}, backend {backend}"
            + (" (ranks share a card: gloo copies through host memory)"
               if shared else ""))


def run_on_mesh(fn, n_devices: int, *args, device=None,
                timeout_s: float = TIMEOUT_S, log=print) -> list:
    """[fn(mesh, *args) of rank r for r < n_devices], each rank a spawned
    process on `device` (every rank; "cpu" for the CPU) or, when None, on
    the card(s) as `rank_devices` maps them.  The backend is chosen from
    that map (`backend_for`) and printed through `log` before the ranks
    start.  Raises `RankError` if any rank raises, dies or is still running
    `timeout_s` seconds after the start."""
    import multiprocessing

    devices = rank_devices(n_devices, device)
    backend = backend_for(devices)
    log(f"run_on_mesh: {fn.__module__}.{fn.__name__}: "
        f"{describe(devices, backend)}")
    if any(d.type == "cuda" for d in devices):
        from .. import kernels

        kernels.library()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tinyram_mesh_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, devices, backend, tmp, timeout_s,
                                   args))
                 for r in range(n_devices)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while True:
                codes = [p.exitcode for p in procs]
                if all(c == 0 for c in codes):
                    break
                if any(c not in (None, 0) for c in codes):
                    time.sleep(1.0)  # let the other ranks write their errors
                    raise RankError(_failure(procs, tmp, "failed"))
                if time.monotonic() > deadline:
                    raise RankError(_failure(procs, tmp, f"still running after "
                                                         f"{timeout_s:.0f} s"))
                procs[codes.index(None)].join(0.05)
            out = []
            for r in range(n_devices):
                with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()


def _failure(procs, tmp, what: str) -> str:
    lines = [f"run_on_mesh: {what}; exit codes "
             f"{[p.exitcode for p in procs]}"]
    for r in range(len(procs)):
        path = os.path.join(tmp, f"error{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                lines.append(f"--- rank {r}:\n{f.read()}")
    return "\n".join(lines)
