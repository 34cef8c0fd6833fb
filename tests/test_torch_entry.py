"""The port's `entry()` (tinyram_tpu_torch/entry.py) against the JAX
package's `__graft_entry__.entry()` on the CPU: the same arguments, bit for
bit, and the same NTT -> multiply -> inverse NTT output, limb for limb
(tolerance 0: the arithmetic is exact)."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402
from tinyram_tpu_torch.entry import entry  # noqa: E402

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them


def test_entry_equals_the_jax_entry():
    jfn, (ja, jb) = graft.entry()
    fn, (a, b) = entry(torch.device("cpu"))
    assert a.dtype == b.dtype == torch.int32
    assert np.array_equal(a.numpy().view(np.uint32), ja)
    assert np.array_equal(b.numpy().view(np.uint32), jb)
    want = np.asarray(jfn(ja, jb))
    got = fn(a, b)
    assert got.shape == (16, 1 << 12)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("with a card the default call runs there (chip_smoke.py)")
    with pytest.raises((AssertionError, RuntimeError)):
        entry()
