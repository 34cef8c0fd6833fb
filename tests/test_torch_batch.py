"""The port's BatchVerifier on the JAX package's recorded W=8 proofs.

tests/data/torch_golden_w8.npz (scripts/torch_golden.py) holds the JAX
package's proving key and two proofs: the Answer-only program and the
memory program (LoadW/StoreW, primary tape [41], answer 42).  Queued
together with their public inputs, `finalize` accepts them with one
combined MSM; with one proof queued under the other program's public
inputs it rejects, and `finalize_detailed` gives the per-proof verdicts of
`verify_proof`.  (Both instance sets are the recorded programs', so the
verifier's instance-commitment cache serves every check after the first
two: a fresh instance set costs a CPU MSM of ~20 s.)
"""

import os
import random

import numpy as np
import pytest
import torch

from tinyram_tpu_torch.convert import pk_from_numpy, points_from_bytes
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.plonk import BatchVerifier, verify_proof
from tinyram_tpu_torch.tinyram import Imm, Instruction, Reg, TinyRamCircuit

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_w8.npz")
ANSWER = [Instruction("Answer", None, None, Imm(0))]
MEMORY = [
    Instruction("LoadW", 0, None, Imm(0)),
    Instruction("Add", 1, 0, Imm(1)),
    Instruction("StoreW", 1, None, Imm(8)),
    Instruction("LoadW", 2, None, Imm(8)),
    Instruction("Answer", None, None, Reg(2)),
]


class SeededRng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


@pytest.fixture(scope="module")
def recorded():
    rec = dict(np.load(GOLDEN))
    rec["fixed_commitments"] = points_from_bytes(rec["fixed_comm"],
                                                 rec["fixed_comm_none"])
    circ = TinyRamCircuit(8, 8)
    srs = setup(circ.k, device="cpu")
    pk = pk_from_numpy(rec, circ.tcs.cs, device="cpu")
    answer = (circ.instance_arrays(ANSWER, 0), rec["proof_answer"].tobytes())
    memory = (circ.instance_arrays(MEMORY, 42, primary=[41]),
              rec["proof_memory"].tobytes())
    wrong = (answer[0], memory[1])  # the memory proof, the answer's inputs
    return srs, pk.vk, answer, memory, wrong


def test_batch_accepts_recorded_proofs(recorded):
    srs, vk, answer, memory, _ = recorded
    bv = BatchVerifier()
    bv.add_proof(*answer)
    bv.add_proof(*memory)
    assert bv.finalize(srs, vk, rng=SeededRng(3))


def test_batch_rejects_wrong_instance_and_details_match(recorded):
    srs, vk, answer, _, wrong = recorded
    bv = BatchVerifier()
    bv.add_proof(*answer)
    bv.add_proof(*wrong)
    assert not bv.finalize(srs, vk, rng=SeededRng(4))
    detailed = bv.finalize_detailed(srs, vk)
    assert detailed == [True, False]
    assert detailed == [verify_proof(srs, vk, i, p) for i, p in bv.items]


def test_batch_rejects_a_proof_with_a_forged_ipa_opening(recorded):
    """A proof whose transcript parses and whose constraint identity holds
    is still rejected once the combined IPA relation is checked: the last
    scalar of the proof (the IPA's final blind) is changed."""
    srs, vk, answer, memory, _ = recorded
    inst, proof = memory
    forged = bytearray(proof)
    forged[-32] ^= 0x01
    bv = BatchVerifier()
    bv.add_proof(*answer)
    bv.add_proof(inst, bytes(forged))
    assert not bv.finalize(srs, vk, rng=SeededRng(5))
    assert BatchVerifier().finalize(srs, vk)  # nothing queued
