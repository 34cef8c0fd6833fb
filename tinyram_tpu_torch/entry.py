"""The port's twin of `__graft_entry__.entry()`: one forward step of the
prover's compute path.

`entry(device)` returns `(fn, (a, b))`: `fn` is NTT -> pointwise
Montgomery multiply -> inverse NTT over Fp at n = 2^12 (the polynomial
product at the heart of quotient evaluation), a plain function on tensors,
and `a`, `b` are its (16, n) limb arguments, drawn as the JAX function
draws them (`np.random.default_rng(0)`, top limb masked with 0x3FFF) and
held as int32 tensors with the same bits.  On the card the transforms run
kernel B2 (four-step, 64 x 64 rows) and the product kernel B1; on the CPU
their plain versions.

Run on the card: `python -c "from tinyram_tpu_torch.entry import entry;
fn, args = entry(); print(fn(*args)[:, :4])"`.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import FP
from .poly import ntt
from .utils.device import CUDA, resolve

LOG_N = 12


def poly_product_step(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The coefficients of a·b mod (X^n - 1) for (16, n) coefficient limbs."""
    fa = ntt(FP, a)
    fb = ntt(FP, b)
    return ntt(FP, FP.mul(fa, fb), inverse=True)


def entry(device=None):
    """(poly_product_step, (a, b)) with a, b on `device` (the card unless
    the caller names another)."""
    dev = resolve(CUDA if device is None else device)
    rng = np.random.default_rng(0)
    limbs = rng.integers(0, 1 << 16, size=(2, 16, 1 << LOG_N)).astype(np.uint32)
    limbs[:, 15] &= 0x3FFF  # keep values < p
    a, b = (torch.as_tensor(x.view(np.int32), device=dev) for x in limbs)
    return poly_product_step, (a, b)
