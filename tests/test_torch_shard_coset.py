"""The k = 6 toy circuit proved on two gloo ranks of the CPU with the
quotient lifted one coset at a time (`shard.paths.toy_proof` within
`utils.device.memory_cap(0)`, as config 4's quotient is where its whole
lift does not fit): both ranks return the JAX package's recorded bytes
(tests/data/torch_golden_toy6.npz, made by scripts/torch_golden_toy.py
under the same seeded stream).  Tolerance 0.  A file of its own, so that
the test workers run it beside the other proofs.
"""

import os

import numpy as np
import torch

from tinyram_tpu_torch.shard import paths
from tinyram_tpu_torch.shard.launch import run_on_mesh

from test_torch_shard import DEADLINE_S

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_toy6.npz")


def test_toy_proof_by_coset_at_two_ranks_equals_jax():
    """Each rank lifts its n/D rows of every coset and halo-exchanges the
    rotations within the coset; the interleaved row blocks go through the
    same inverse transform and gather as the whole lift's."""
    rec = dict(np.load(GOLDEN))
    ranks = run_on_mesh(paths.toy_proof, 2, int(rec["seed"]), 0,
                        device="cpu", timeout_s=DEADLINE_S)
    assert [r["proof"] for r in ranks] == [rec["proof"].tobytes()] * 2
    assert ranks[0]["verified"] and ranks[-1]["rejected"]
