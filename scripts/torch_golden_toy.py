"""Record the JAX package's k = 6 toy-circuit proof as a fixture.

Usage: JAX_PLATFORMS=cpu python scripts/torch_golden_toy.py [out.npz]

The circuit and witness are those of `__graft_entry__.dryrun_multichip`
and tests/test_shard_prover.py (y = x², a bound public input, a range
lookup and one copy constraint, k = 6).  The prover's randomness is drawn
from `secrets.randbelow`; here it is replaced by a seeded stream, and the
port's `create_proof(rng=...)` draws the same values in the same order,
single-device or on a mesh, so the proof bytes must agree exactly
(tests/test_torch_toy_proof.py, tests/test_torch_shard_prover.py).

Recorded (default tests/data/torch_golden_toy6.npz):
  k, seed
  fixed_comm       (num_fixed, 2, 32) uint8 little-endian x, y
  fixed_comm_none  (num_fixed,) bool, identity commitments
  sigma_comm, sigma_comm_none   the same for the permutation columns
  public           (n,) uint8 x 32: the instance column, little-endian
  proof            the proof bytes under SeededRng(seed)
"""

from __future__ import annotations

import os
import secrets
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from torch_golden import SeededRng, _point_bytes  # noqa: E402

SEED = 3


def main(out: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tests.test_shard_prover import K, N, P, _witness, build_cs
    from tinyram_tpu.ipa import setup
    from tinyram_tpu.plonk import Assignment, create_proof, keygen, verify_proof

    cs, q, t_rng, x, y, pub = build_cs()
    cols = (q, t_rng, x, y, pub)
    srs = setup(K)
    asg0 = Assignment(cs, N)
    u = cs.usable_rows(N)
    asg0.set(q, [1] * u + [0] * (N - u))
    asg0.set(t_rng, list(range(16)) + [0] * (N - 16))
    pk = keygen(srs, cs, asg0)
    xs = [3, 3] + [(i * 7) % 16 for i in range(2, u)]
    public = [v * v % P for v in xs] + [0] * (N - len(xs))

    saved = secrets.randbelow
    secrets.randbelow = SeededRng(SEED).randbelow
    try:
        t0 = time.time()
        proof = create_proof(srs, pk, _witness(cs, cols, xs))
        print(f"prove {time.time() - t0:.1f}s", flush=True)
    finally:
        secrets.randbelow = saved
    assert verify_proof(srs, pk.vk, [public], proof)

    def comms(points):
        pairs = [_point_bytes(p) for p in points]
        return (np.stack([c for c, _ in pairs]).reshape(-1, 2, 32),
                np.array([none for _, none in pairs], dtype=bool))

    fixed, fixed_none = comms(pk.vk.fixed_commitments)
    sigma, sigma_none = comms(pk.vk.sigma_commitments)
    rec = {
        "k": np.array(K), "seed": np.array(SEED),
        "fixed_comm": fixed, "fixed_comm_none": fixed_none,
        "sigma_comm": sigma, "sigma_comm_none": sigma_none,
        "public": np.stack([np.frombuffer(int(v).to_bytes(32, "little"),
                                          np.uint8) for v in public]),
        "proof": np.frombuffer(proof, np.uint8),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **rec)
    print(f"wrote {out} ({len(proof)} proof bytes)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "data", "torch_golden_toy6.npz"))
