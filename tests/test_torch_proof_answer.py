"""The port's W=8 proof of the Answer-only program (BASELINE config 1),
made through its end-to-end entry point `gen_proof_and_verify` (setup,
keygen, prove, verify), is byte for byte the JAX package's recorded proof
made under the same seeded random stream (tests/data/torch_golden_w8.npz,
scripts/torch_golden.py), and the port's verifier accepts it.  The proof
is made inside `utils.profiling.recording()`, and its witness and lookup
spans are recorded (tests/test_torch_spans.py checks the rest).
"""

import os
import random

import numpy as np
import torch

from tinyram_tpu_torch.tinyram import Imm, Instruction, gen_proof_and_verify
from tinyram_tpu_torch.utils import profiling

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_w8.npz")
SEED = 1  # scripts/torch_golden.py SEED_ANSWER


class SeededRng:
    """randbelow(n) from random.Random(seed): the stream the recorded JAX
    proof drew through secrets.randbelow."""

    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def test_answer_proof_bytes_equal_jax():
    want = np.load(GOLDEN)["proof_answer"].tobytes()
    prog = [Instruction("Answer", None, None, Imm(0))]
    profiling.log.clear()
    with profiling.recording():
        trace, proof, ok = gen_proof_and_verify(8, 8, prog, device="cpu",
                                               rng=SeededRng(SEED))
    assert trace.answer == 0
    assert proof == want
    assert ok
    names = {(e[0], e[1]) for e in profiling.spans()}
    assert {(f"witness.{w}", None) for w in ("fixed", "exe", "instance",
                                            "encode")} <= names
    lookup = "prover.lookup permute+commit"
    assert {(f"lookup.{w}", lookup) for w in (
        "compress", "fetch", "permute", "upload", "multiplicity")} <= names
