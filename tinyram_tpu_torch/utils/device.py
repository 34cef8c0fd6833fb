"""The device of the port's entry points.

Entry points run on the card unless the caller names another device
(`device="cpu"`, as the CPU tests do).  `resolve` touches the device once,
so that a missing card raises at the call instead of after host work.
`free_bytes` is what the prover reads to choose how much of a phase it
holds at once; `memory_cap` bounds it (a card shared with another program,
or a test of the narrow path at a small size).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

CUDA = torch.device("cuda")


def resolve(device) -> torch.device:
    """`device` as a `torch.device`; raises if it is not there."""
    dev = torch.device(device)
    torch.empty(0, device=dev)
    return dev


_CAPS: list = []


@contextmanager
def memory_cap(nbytes: int):
    """Within the block, `free_bytes` reports at most `nbytes`."""
    _CAPS.append(nbytes)
    try:
        yield
    finally:
        _CAPS.pop()


def free_bytes(device) -> int | None:
    """The bytes `device` can still allocate: the card's free memory plus
    what PyTorch's allocator holds unused, None on the CPU (no bound is
    observed), at most the innermost `memory_cap`."""
    dev = torch.device(device)
    free = None
    if dev.type == "cuda":
        free = (torch.cuda.mem_get_info(dev)[0]
                + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
    if _CAPS:
        free = _CAPS[-1] if free is None else min(free, _CAPS[-1])
    return free
