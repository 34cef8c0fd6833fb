"""The device of the port's entry points.

Entry points run on the card unless the caller names another device
(`device="cpu"`, as the CPU tests do).  `resolve` touches the device once,
so that a missing card raises at the call instead of after host work.
"""

from __future__ import annotations

import torch

CUDA = torch.device("cuda")


def resolve(device) -> torch.device:
    """`device` as a `torch.device`; raises if it is not there."""
    dev = torch.device(device)
    torch.empty(0, device=dev)
    return dev
