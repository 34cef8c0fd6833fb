"""The port's verifier on the JAX package's recorded W=8 memory proof
(tests/data/torch_golden_w8.npz): it accepts the proof for its own public
inputs and rejects it for a wrong answer and for a wrong public tape, as
tests/test_tinyram_proof.py::test_proof_memory_program does for the JAX
verifier.
"""

import os

import numpy as np
import pytest
import torch

from tinyram_tpu_torch.convert import pk_from_numpy, points_from_bytes
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.tinyram import Imm, Instruction, Reg, TinyRamCircuit

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_w8.npz")
MEMORY = [
    Instruction("LoadW", 0, None, Imm(0)),
    Instruction("Add", 1, 0, Imm(1)),
    Instruction("StoreW", 1, None, Imm(8)),
    Instruction("LoadW", 2, None, Imm(8)),
    Instruction("Answer", None, None, Reg(2)),
]


@pytest.fixture(scope="module")
def verifier_inputs():
    rec = dict(np.load(GOLDEN))
    rec["fixed_commitments"] = points_from_bytes(rec["fixed_comm"],
                                                 rec["fixed_comm_none"])
    circ = TinyRamCircuit(8, 8)
    srs = setup(circ.k, device="cpu")
    pk = pk_from_numpy(rec, circ.tcs.cs, device="cpu")
    return circ, srs, pk, rec["proof_memory"].tobytes()


@pytest.mark.parametrize("answer,tape,accepted", [
    (42, [41], True),
    (43, [41], False),  # wrong answer
    (42, [40], False),  # wrong public tape
    (42, [], False),  # tape withheld
])
def test_verifier_on_jax_memory_proof(verifier_inputs, answer, tape, accepted):
    circ, srs, pk, proof = verifier_inputs
    assert circ.verify(srs, pk, MEMORY, answer, proof, primary=tape) is accepted
