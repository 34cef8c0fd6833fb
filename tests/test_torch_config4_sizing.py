"""Config 4's sizing on the CPU: every narrower pass gives the JAX bytes.

Config 4 (k = 21) is proved on one card with its witness in host memory and
narrow passes (`tinyram.prove_config.SIZING[4]`): MSM passes of fewer than
four columns (`ipa.pass_widths`), keygen's and the verifier's instance
commitments in such passes, and the quotient lifted one coset of the
extended domain at a time where its whole lift does not fit in the
device's free memory (`prover._lift_whole`, forced here by
`utils.device.memory_cap(0)`).  Here, at small sizes, held to the JAX
package:

  * the pass widths below four columns;
  * the k = 6 toy circuit's keygen at commit_chunk 1 and 2 equal to the
    recorded JAX key (tests/data/torch_golden_toy6.npz); the W=8 verifier's
    instance commitments (three columns) at 1 and 2 equal to the JAX
    package's domain transform and host MSM oracle on the same columns
    (each pass of a few columns is a bit-serial MSM of seconds on a CPU:
    the widths are tried on few columns); the recorded JAX toy proof
    verified with one-column passes (its instance commitment is absorbed
    into the transcript);
  * the toy proof at config 4's sizing (assignment stored as on the host,
    transforms and MSMs of 2 columns, gate and evaluation slabs of 8, the
    coset lift)
    equal to the recorded JAX bytes (on D = 2 ranks in
    test_torch_shard_coset.py);
  * the per-coset quotient equal to the whole lift, bit for bit, on the
    k = 6 toy circuit and the W=8 TinyRAM circuit (random coefficient
    columns for every column the quotient reads: the W=8 lookups span
    several expression chunks, which the toy's do not);
  * with `-m slow`, `prove_config(4, k=10)` through every stage to verify
    at config 4's sizing (minutes on a CPU: the bit-serial MSM).
"""

import os

import numpy as np
import pytest
import torch

from tinyram_tpu.curve import host as jhost
from tinyram_tpu.field.jfield import FP as JFP
from tinyram_tpu.ipa import srs as jsrs
from tinyram_tpu.poly.domain import Domain as JDomain
from tinyram_tpu_torch.convert import points_from_bytes
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.ipa.ipa import pass_widths
from tinyram_tpu_torch.plonk import create_proof, keygen, verifier
from tinyram_tpu_torch.plonk import prover
from tinyram_tpu_torch.plonk.prover import quotient_coeff
from tinyram_tpu_torch.plonk.toy import K as TOY_K
from tinyram_tpu_torch.plonk.toy import toy_circuit
from tinyram_tpu_torch.poly.domain import Domain
from tinyram_tpu_torch.shard import paths
from tinyram_tpu_torch.tinyram import Imm, Instruction, TinyRamCircuit
from tinyram_tpu_torch.tinyram import prove_config as pc
from tinyram_tpu_torch.utils.device import memory_cap

from test_torch_shard import _quotient_pids

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOY_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_toy6.npz")
ANSWER = [Instruction("Answer", None, None, Imm(0))]


@pytest.fixture(scope="module")
def toy():
    """(the toy circuit, its SRS, its key, the recorded JAX proof)."""
    rec = dict(np.load(TOY_GOLDEN))
    circ = toy_circuit()
    srs = setup(TOY_K, device="cpu")
    pk = keygen(srs, circ.cs, circ.fixed_assignment("cpu"))
    return circ, srs, pk, rec


@pytest.mark.parametrize("cols,chunk,want", [
    (5, 1, [1] * 5), (5, 2, [2, 2, 1]), (5, 3, [4, 2]), (3, 4, [4]),
    (5, 4, [4, 4]), (70, 64, [64, 8]), (1, 64, [4])])
def test_pass_widths(cols, chunk, want):
    assert pass_widths(cols, chunk) == want


@pytest.mark.parametrize("chunk", [1, 2])
def test_keygen_narrow_passes_equal_jax(chunk):
    """The k = 6 toy circuit's key (two fixed columns and one sigma) at
    passes of 1 and 2 columns: the recorded JAX commitments."""
    rec = dict(np.load(TOY_GOLDEN))
    circ = toy_circuit()
    srs = setup(TOY_K, device="cpu")
    pk = keygen(srs, circ.cs, circ.fixed_assignment("cpu"),
                commit_chunk=chunk)
    assert pk.vk.fixed_commitments == points_from_bytes(
        rec["fixed_comm"], rec["fixed_comm_none"])
    assert pk.vk.sigma_commitments == points_from_bytes(
        rec["sigma_comm"], rec["sigma_comm_none"])


@pytest.fixture(scope="module")
def instance_case():
    """The W=8 verifier's first three instance columns (as the verifier
    takes them), and the JAX package's coefficients and commitments of
    them: its domain's transform and its host MSM over its SRS points."""
    circ = TinyRamCircuit(8, 8)
    k = circ.k
    n = 1 << k
    columns = [verifier._instance_values(col, n)
               for col in circ.instance_arrays(ANSWER, 0)[:3]]
    jdom = JDomain(JFP, k, k + circ.tcs.cs.extension_factor_log2())
    jcoeff = jdom.lagrange_to_coeff(np.stack(
        [np.asarray(JFP.encode([int(v) % JFP.modulus for v in col]))
         for col in columns], axis=1))
    coeffs = [JFP.decode(jcoeff[:, i]) for i in range(len(columns))]
    g_host = jsrs._gen_host(k)[0]
    want = [jhost.msm(c, g_host) for c in coeffs]
    return circ, columns, coeffs, want


@pytest.mark.parametrize("chunk", [1, 2])
def test_verifier_instance_commit_narrow_passes_equal_jax(instance_case,
                                                          chunk):
    circ, columns, want_coeffs, want = instance_case
    srs = setup(circ.k, device="cpu")
    dom = Domain(FP, circ.k, circ.k + circ.tcs.cs.extension_factor_log2(),
                 "cpu")
    verifier.clear_instance_cache()
    got_coeff, got = verifier._instance_commitments(srs, dom, columns, chunk)
    verifier.clear_instance_cache()
    assert got == want and len(got) == 3
    assert [FP.decode(c) for c in got_coeff] == want_coeffs


def test_verifier_accepts_jax_toy_proof_at_one_column_passes(toy):
    circ, srs, pk, rec = toy
    good = circ.public_values(circ.witness_values())
    verifier.clear_instance_cache()
    assert verifier.verify_proof(srs, pk.vk, [good], rec["proof"].tobytes(),
                                 commit_chunk=1)
    verifier.clear_instance_cache()


def test_toy_proof_at_config4_sizing_equals_jax(toy):
    circ, srs, pk, rec = toy
    asg = circ.assignment(device="cpu", host=True)
    with memory_cap(0):
        proof = create_proof(srs, pk, asg, rng=paths.SeededRng(
            int(rec["seed"])), **pc.SIZING[4].prover())
    assert proof == rec["proof"].tobytes()


def _random_coeffs(cs, k: int, seed: int) -> dict:
    gen = np.random.default_rng(seed)
    return {pid: FP.encode(gen.integers(0, 1 << 62, size=1 << k),
                           device="cpu")
            for pid in _quotient_pids(cs)}


@pytest.mark.parametrize("case", ["toy6", "w8"])
def test_quotient_by_coset_equals_whole_lift(case):
    if case == "toy6":
        cs, k = toy_circuit().cs, TOY_K
    else:
        circ = TinyRamCircuit(8, 8)
        cs, k = circ.tcs.cs, circ.k
    dom = Domain(FP, k, k + cs.extension_factor_log2(), "cpu")
    coeff = _random_coeffs(cs, k, 6 + k)
    ch = (11, 12, 13, 14)
    args = (cs, dom, coeff, ch, cs.usable_rows(dom.n),
            cs.permutation_columns())
    assert prover._lift_whole(cs, dom, 8, None)
    want = quotient_coeff(*args)
    with memory_cap(0):
        assert not prover._lift_whole(cs, dom, 8, None)
        got = quotient_coeff(*args, ext_chunk=8, gate_slab=8)
    assert want.shape == (16, dom.n_ext) and want.any()
    assert torch.equal(got, want)


@pytest.mark.slow
def test_prove_config4_k10_every_stage_at_config4_sizing():
    heard = []
    report = pc.prove_config(4, 8, device="cpu", word_bits=16, k=10,
                             cache_dir=None, log=lambda m: None,
                             on_stage=lambda *a: heard.append(a[0]))
    assert heard == ["emulate", "emulate native", "witness", "mock",
                     "srs setup", "keygen", "prove", "verify",
                     "verify answer+1"]
    assert report["sizing"] == {"host": True, "ext_chunk": 2,
                                "gate_slab": 8, "commit_chunk": 2,
                                "eval_slab": 8}
    assert report["mock_failures"] == [] and report["proof_bytes"] > 0
