"""The port's W=8 proof of the memory program (LoadW/StoreW, primary tape
[41]) is byte for byte the JAX package's recorded proof, made under the same
seeded random stream (tests/data/torch_golden_w8.npz,
scripts/torch_golden.py).
"""

import os
import random

import numpy as np
import torch

from tinyram_tpu_torch.convert import pk_from_numpy, points_from_bytes
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.tinyram import (
    Imm,
    Instruction,
    Reg,
    TinyRamCircuit,
    eval_program,
)

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_w8.npz")
SEED = 2  # scripts/torch_golden.py SEED_MEMORY
TAPE = [41]
MEMORY = [
    Instruction("LoadW", 0, None, Imm(0)),
    Instruction("Add", 1, 0, Imm(1)),
    Instruction("StoreW", 1, None, Imm(8)),
    Instruction("LoadW", 2, None, Imm(8)),
    Instruction("Answer", None, None, Reg(2)),
]


class SeededRng:
    """randbelow(n) from random.Random(seed): the stream the recorded JAX
    proof drew through secrets.randbelow."""

    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def test_memory_proof_bytes_equal_jax():
    rec = dict(np.load(GOLDEN))
    rec["fixed_commitments"] = points_from_bytes(rec["fixed_comm"],
                                                 rec["fixed_comm_none"])
    circ = TinyRamCircuit(8, 8)
    srs = setup(circ.k, device="cpu")
    pk = pk_from_numpy(rec, circ.tcs.cs, device="cpu")
    trace = eval_program(MEMORY, 8, 8, primary_tape=TAPE)
    assert trace.answer == 42
    proof = circ.prove(srs, pk, trace, rng=SeededRng(SEED))
    assert proof == rec["proof_memory"].tobytes()
