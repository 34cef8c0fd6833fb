"""Record the JAX package's W=8 TinyRAM proving key and proofs as a fixture.

Usage: JAX_PLATFORMS=cpu python scripts/torch_golden.py [out.npz]

The PyTorch port (tinyram_tpu_torch) is held against these recordings in
tests/test_torch_proof*.py: a live JAX proof takes minutes on a CPU, most of
it XLA compiles, so the tests read the recorded output instead.  The
prover's randomness is drawn from `secrets.randbelow`; here it is replaced
by a seeded stream, and the port's `create_proof(rng=...)` draws the same
values in the same order, so the proof bytes must agree exactly.

Recorded (default tests/data/torch_golden_w8.npz):
  k, fixed_lag/fixed_coeff  (num_fixed, 16, n) uint16 limbs, Montgomery form
  fixed_comm                (num_fixed, 2, 32) uint8 little-endian x, y
  fixed_comm_none           (num_fixed,) bool, identity commitments
  proof_answer              Answer-only program, seed SEED_ANSWER
  proof_memory              LoadW/StoreW program with primary tape [41],
                            seed SEED_MEMORY
"""

from __future__ import annotations

import os
import random
import secrets
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

SEED_ANSWER = 1
SEED_MEMORY = 2
WORD_BITS = 8
REG_COUNT = 8


class SeededRng:
    """`randbelow(n)` from a seeded `random.Random` (same stream as the
    tests hand to the port's create_proof)."""

    def __init__(self, seed: int):
        self._r = random.Random(seed)

    def randbelow(self, n: int) -> int:
        return self._r.randrange(n)


def programs():
    from tinyram_tpu.tinyram import Imm, Instruction, Reg

    def I(op, ri=None, rj=None, a=0, areg=None):
        return Instruction(op, ri, rj, Reg(areg) if areg is not None else Imm(a))

    answer = [I("Answer", a=0)]
    memory = [
        I("LoadW", ri=0, a=0),
        I("Add", ri=1, rj=0, a=1),
        I("StoreW", ri=1, a=8),
        I("LoadW", ri=2, a=8),
        I("Answer", areg=2),
    ]
    return answer, memory


def _point_bytes(pt):
    if pt is None:
        return np.zeros((2, 32), np.uint8), True
    return np.stack([
        np.frombuffer(int(c).to_bytes(32, "little"), np.uint8) for c in pt
    ]), False


def main(out: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tinyram_tpu.ipa import setup
    from tinyram_tpu.tinyram import TinyRamCircuit, eval_program

    circ = TinyRamCircuit(WORD_BITS, REG_COUNT)
    srs = setup(circ.k)
    t0 = time.time()
    pk = circ.keygen(srs)
    print(f"keygen {time.time() - t0:.1f}s", flush=True)

    def limbs(cols):
        return np.stack([np.asarray(c) for c in cols]).astype(np.uint16)

    comm = [_point_bytes(p) for p in pk.vk.fixed_commitments]
    rec = {
        "k": np.array(circ.k),
        "fixed_lag": limbs(pk.fixed_lag),
        "fixed_coeff": limbs(pk.fixed_coeff),
        "fixed_comm": np.stack([c for c, _ in comm]),
        "fixed_comm_none": np.array([none for _, none in comm]),
    }
    assert not pk.sigma_lag, "the TinyRAM circuit has no copy constraints"

    answer, memory = programs()
    saved = secrets.randbelow
    try:
        for name, prog, tape, seed in (
            ("answer", answer, [], SEED_ANSWER),
            ("memory", memory, [41], SEED_MEMORY),
        ):
            tr = eval_program(prog, WORD_BITS, REG_COUNT, primary_tape=tape)
            secrets.randbelow = SeededRng(seed).randbelow
            t0 = time.time()
            proof = circ.prove(srs, pk, tr)
            print(f"prove {name} {time.time() - t0:.1f}s", flush=True)
            secrets.randbelow = saved
            assert circ.verify(srs, pk, prog, tr.answer, proof, primary=tape)
            rec[f"proof_{name}"] = np.frombuffer(proof, np.uint8)
    finally:
        secrets.randbelow = saved
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **rec)
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "data", "torch_golden_w8.npz"))
