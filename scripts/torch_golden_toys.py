"""Record the JAX package's proofs of its toy-circuit tests as a fixture.

Usage: JAX_PLATFORMS=cpu python scripts/torch_golden_toys.py [out.npz]

The seven proof tests of tests/test_plonk.py (K = 3: roundtrip, soundness,
bad witness) and tests/test_range_lookup.py (K = 6: roundtrip, out of
range, forged multiplicity, mixed with a tuple plookup), run with the JAX
package on the CPU.  Each proof draws the prover's randomness from a
seeded stream (`secrets.randbelow` replaced, as in
scripts/torch_golden_toy.py) with the seed of
`tinyram_tpu_torch.plonk.toy.TOY_TESTS`; the port's `create_proof(rng=)`
draws the same values in the same order, so its bytes must be equal
(tests/test_torch_toy_circuits.py, chip_smoke.py).

Recorded (default tests/data/torch_golden_toys.npz), per circuit C of
`TOY_CIRCUITS` and per test T of `TOY_TESTS`:
  C/k                    the circuit's K
  C/fixed_comm           (num_fixed, 2, 32) uint8 little-endian x, y
  C/fixed_comm_none      (num_fixed,) bool, identity commitments
  C/sigma_comm, C/sigma_comm_none   the same for the permutation columns
  T/seed                 the stream's seed
  T/public               (columns, n, 32) uint8: the instance columns
  T/proof                the proof bytes (absent where the prover raised)
  T/error                the ValueError's text (where it raised)
  T/outcome/<check>      the verdicts of `toy.toy_outcomes` (and the
                         mixed test's two mock verdicts) as the JAX
                         verifier and mock prover give them
"""

from __future__ import annotations

import os
import secrets
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from torch_golden import SeededRng, _point_bytes  # noqa: E402


def jax_circuits():
    """circuit -> (cs, key assignment, witness(test) -> (asg, instances),
    mock checks or None), built with the JAX tests' own builders."""
    import test_plonk as tp
    import test_range_lookup as tr
    from tinyram_tpu.plonk import Assignment, ConstraintSystem

    cs, cols = tp.build_cs()

    def plonk_witness(test):
        asg, inst_v = tp.build_assignment(
            cs, cols, tamper="mul" if test == "plonk_bad_witness" else None)
        return asg, [inst_v]

    out = {"plonk": (cs, tp.build_assignment(cs, cols)[0], plonk_witness,
                     None)}
    vals = {
        "range_roundtrip": lambda ci, r: (5 * ci + 2 * r) % 16,
        "range_out_of_range":
            lambda ci, r: 99 if (ci, r) == (0, 0) else r % 16,
        "range_forged_m": lambda ci, r: (ci + r) % 16,
    }
    for name, n_inputs in (("range5", 5), ("range2", 2)):
        rcs, t_rng, rcols = tr._build(n_inputs=n_inputs)
        out[name] = (
            rcs, tr._assign(rcs, t_rng, rcols, lambda ci, r: 0),
            lambda test, a=(rcs, t_rng, rcols): (tr._assign(*a, vals[test]),
                                                 []),
            None)

    # test_range_lookup_mixed_with_plookup's circuit, as the test builds it
    N = tr.N
    mcs = ConstraintSystem()
    t_rng = mcs.fixed_column("t_rng")
    t_sq_x = mcs.fixed_column("t_sq_x")
    t_sq_y = mcs.fixed_column("t_sq_y")
    q = mcs.fixed_column("q")
    x = mcs.advice_column("x")
    y = mcs.advice_column("y")
    mcs.blinding_factors = 4
    mcs.range_lookup("rng", [x.cur(), y.cur()], t_rng.cur())
    mcs.lookup("sq", [q.cur() * x.cur(), q.cur() * y.cur()],
               [t_sq_x.cur(), t_sq_y.cur()])
    u = mcs.usable_rows(N)

    def assign(xs, ys):
        asg = Assignment(mcs, N)
        asg.set(t_rng, [i % 16 for i in range(N)])
        asg.set(t_sq_x, [i % 8 for i in range(N)])
        asg.set(t_sq_y, [(i % 8) ** 2 % 16 for i in range(N)])
        asg.set(q, [1] * u + [0] * (N - u))
        asg.set(x, xs + [0] * (N - len(xs)))
        asg.set(y, ys + [0] * (N - len(ys)))
        return asg

    xs = [i % 8 for i in range(u)]
    ys = [(i % 8) ** 2 % 16 for i in range(u)]
    ys_bad = list(ys)
    ys_bad[3] = (ys_bad[3] + 1) % 16
    out["mixed"] = (mcs, assign([0] * u, [0] * u),
                    lambda test: (assign(xs, ys), []),
                    (assign(xs, ys), assign(xs, ys_bad)))
    return out


def main(out: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tinyram_tpu.ipa import setup
    from tinyram_tpu.plonk import MockProver, create_proof, keygen, verify_proof
    from tinyram_tpu_torch.plonk.toy import TOY_CIRCUITS, TOY_TESTS, toy_outcomes

    circuits = jax_circuits()
    srs = {k: setup(k) for k in sorted({k for _, k in TOY_CIRCUITS.values()})}
    rec, keys = {}, {}

    def comms(points):
        pairs = [_point_bytes(p) for p in points]
        return (np.array([c for c, _ in pairs], np.uint8).reshape(-1, 2, 32),
                np.array([none for _, none in pairs], dtype=bool))

    for name, (cs, key_asg, _, _) in circuits.items():
        k = TOY_CIRCUITS[name][1]
        t0 = time.time()
        pk = keys[name] = keygen(srs[k], cs, key_asg)
        print(f"{name}: keygen {time.time() - t0:.1f}s", flush=True)
        rec[f"{name}/k"] = np.array(k)
        rec[f"{name}/fixed_comm"], rec[f"{name}/fixed_comm_none"] = comms(
            pk.vk.fixed_commitments)
        rec[f"{name}/sigma_comm"], rec[f"{name}/sigma_comm_none"] = comms(
            pk.vk.sigma_commitments)

    for test, (name, seed) in TOY_TESTS.items():
        _, _, witness, mock = circuits[name]
        s = srs[TOY_CIRCUITS[name][1]]
        pk = keys[name]
        asg, instances = witness(test)
        rec[f"{test}/seed"] = np.array(seed)
        rec[f"{test}/public"] = np.array(
            [[np.frombuffer(int(v).to_bytes(32, "little"), np.uint8)
              for v in col] for col in instances],
            np.uint8) if instances else np.zeros((0, 0, 32), np.uint8)
        saved = secrets.randbelow
        secrets.randbelow = SeededRng(seed).randbelow
        t0 = time.time()
        try:
            proof = create_proof(s, pk, asg)
        except ValueError as e:
            if test != "range_out_of_range":
                raise
            rec[f"{test}/error"] = np.array(str(e))
            print(f"{test}: ValueError {e}", flush=True)
            continue
        finally:
            secrets.randbelow = saved
        prove_s = time.time() - t0
        rec[f"{test}/proof"] = np.frombuffer(proof, np.uint8)
        outcomes = toy_outcomes(
            test, lambda inst, p: verify_proof(s, pk.vk, inst, p), instances,
            proof)
        if mock is not None:
            outcomes["mock_clean"] = MockProver(cs, mock[0]).verify() == []
            outcomes["mock_names_sq"] = any(
                f.name == "sq" for f in MockProver(cs, mock[1]).verify())
        for check, v in outcomes.items():
            rec[f"{test}/outcome/{check}"] = np.array(v)
        print(f"{test}: prove {prove_s:.1f}s, {len(proof)} bytes, {outcomes}",
              flush=True)
    assert "range_out_of_range/error" in rec, "the out-of-range proof was made"

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **rec)
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "tests", "data", "torch_golden_toys.npz"))
