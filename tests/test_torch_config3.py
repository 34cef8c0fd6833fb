"""The config-3 slice of the port against the JAX package, on the CPU.

Tolerance 0 throughout: equal limbs, or equal affine points where only the
projective representation may differ.
- `domain_cache` returns one object per key, and its transforms equal
  `tinyram_tpu.poly.domain_cache`'s at k = 10;
- `vesta.scalar_mul` (the ladder B5l's plain loop here) equals
  `tinyram_tpu.curve.vesta.scalar_mul` on a batch of 4 with 255 seeded bits;
- the MSM at c = 16 (config 3's window: 16 windows of 2^15 signed buckets,
  the suffix scan B4s at S = 128 over H = 256 lanes a window, B6h with 16
  doublings a window, the doubling chains of 7 and 15) equals the JAX
  package's host oracle `tinyram_tpu.curve.host.msm` (and the port's copy
  of it); its window combine equals the JAX `_combine_windows_inner` at
  c = 16 (the JAX `msm_many` at c = 16 does not compile on the CPU in
  minutes);
- the SRS generators hashed in a pool of processes equal the serial
  hashing, and a smaller k's are the prefix of a larger k's;
- the prover's expression evaluation frees its memoized columns when it
  returns, with the garbage collector off (a reference cycle kept them,
  and the warm config-3 proofs' peak device memory grew with them);
- `config3_program` at W = 16, k = 10 through the port's config-3 driver
  (`prove_config.prove_config(3)`, mock only): its mock finds no failure, as
  the JAX `MockProver` does, and a forged memory value is named identically
  by both.

The four-step NTT at config 3's 2^19 points is held against the JAX
package in tests/test_torch_config3_ntt.py (a file of its own: its JAX side
alone takes over a minute on one CPU).
"""

import gc
import importlib
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyram_tpu.plonk as jplonk
from tinyram_tpu.curve import host as jhost
from tinyram_tpu.curve import vesta as jv
from tinyram_tpu.field import FP as JFP
from tinyram_tpu.poly import domain_cache as jdomain_cache
from tinyram_tpu.tinyram import TinyRamCircuit as JCircuit
from tinyram_tpu.tinyram import eval_program as jeval
from tinyram_tpu.tinyram.bench_programs import config3_program as jconfig3
from tinyram_tpu_torch.curve import host, scalar_mul
from tinyram_tpu_torch.curve.vesta import PointBatch, from_affine_host, to_affine_host
from tinyram_tpu_torch.field import FP, FQ
from tinyram_tpu_torch.ipa import srs
from tinyram_tpu_torch.ipa.srs import _hash_to_curve
from tinyram_tpu_torch.plonk import MockProver
from tinyram_tpu_torch.plonk.expr import Var, evaluate
from tinyram_tpu_torch.poly import domain_cache
from tinyram_tpu_torch.tinyram.prove_config import prove_config

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

jmsm = importlib.import_module("tinyram_tpu.curve.msm")
tmsm = importlib.import_module("tinyram_tpu_torch.curve.msm")


def _limbs(x) -> np.ndarray:
    """Port int32 or JAX uint32 limbs as int64 (the same bits)."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64) & 0xFFFFFFFF


def _jax(p):
    return jv.PointBatch(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in p))


def _fp_values(rng, n):
    limbs = rng.integers(0, 1 << 16, size=(16, n)).astype(np.int64)
    limbs[15] &= 0x3FFF  # < 2^254 < p
    return limbs


@pytest.fixture(scope="module")
def pool():
    return [_hash_to_curve(b"torch-config3", i) for i in range(48)]


def test_domain_cache_one_object_per_key():
    d = domain_cache("Fp", 10, 12, "cpu")
    assert domain_cache("Fp", 10, 12, "cpu") is d
    assert domain_cache("Fp", 10, 12, torch.device("cpu")) is d
    assert domain_cache("Fp", 10, 13, "cpu") is not d
    assert domain_cache("Fq", 10, 12, "cpu") is not d
    assert domain_cache("Fq", 10, 12, "cpu").field is FQ
    assert (d.k, d.extended_k, d.n_ext, d.device.type) == (10, 12, 1 << 12, "cpu")


@pytest.mark.parametrize("transform", ["lagrange_to_coeff", "coeff_to_extended",
                                       "extended_to_coeff"])
def test_domain_cache_transforms_match_jax(transform):
    rng = np.random.default_rng(3)
    n = 1 << (12 if transform == "extended_to_coeff" else 10)
    x = _fp_values(rng, n)
    got = getattr(domain_cache("Fp", 10, 12, "cpu"), transform)(
        torch.as_tensor(x.astype(np.int32)))
    want = getattr(jdomain_cache("Fp", 10, 12), transform)(
        jnp.asarray(x.astype(np.uint32)))
    np.testing.assert_array_equal(_limbs(got), _limbs(want))


def test_scalar_mul_matches_jax(pool):
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(255, 4))
    p = from_affine_host([pool[0], pool[1], None, pool[2]], "cpu")
    got = scalar_mul(torch.as_tensor(bits), p)
    want = jv.scalar_mul(jnp.asarray(bits.astype(np.uint32)), _jax(p))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_limbs(a), _limbs(b))
    # and the affine points of the host oracle
    for lane, pt in enumerate([pool[0], pool[1], None, pool[2]]):
        s = int("".join(str(int(b)) for b in bits[:, lane]), 2)
        assert to_affine_host(PointBatch(*(c[:, lane:lane + 1] for c in got))) \
            == [host.scalar_mul(s, pt) if pt is not None else None]


def test_msm_window_16_matches_host_oracle(pool):
    """The whole Pippenger pipeline at c = 16 (the plan config 3's commits
    take) on 48 points, identity points and repeated points among them,
    against the JAX package's affine `msm` (None is its identity)."""
    rng = np.random.default_rng(7)
    pts = [None if i % 11 == 5 else pool[i % 40] for i in range(48)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % FP.modulus for _ in pts]
    scalars[3] = 0
    scalars[4] = FP.modulus - 1
    plain = FP.from_mont(FP.encode(scalars, device="cpu"))
    out = tmsm._msm_pippenger(plain[:, None, :], from_affine_host(pts, "cpu"), 16,
                              tmsm.GROUP_LOG2, tmsm.LANES_LOG2)
    want = jhost.msm(scalars, pts)
    assert want is not None
    assert to_affine_host(out) == [want]
    assert host.msm(scalars, pts) == want


def test_window_combine_16_matches_jax(pool):
    """B6h's plain loop at config 3's 16 windows of c = 16, two lanes."""
    ws = PointBatch(*(c.reshape(16, 16, 2)
                      for c in from_affine_host(pool[:32], "cpu")))
    got = tmsm._combine_windows(ws, 16)
    want = jmsm._combine_windows_inner(_jax(ws), 16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_limbs(a), _limbs(b))


def test_srs_pool_and_prefix_equal_serial_hashing():
    """The SRS generators of config 3's set-up: hashed in a pool of spawned
    processes (in chunks, in index order) they equal the serial hashing, and
    a smaller k's generators are the prefix of a larger one's."""
    hi = 2 * srs._POOL_CHUNK + 5
    serial = srs._hash_range(0, hi)
    assert srs.hash_generators(0, hi, workers=2) == serial
    assert srs._generators(64) == serial[:64]
    assert srs._generators(16) == serial[:16]


def test_evaluate_frees_its_memoized_columns():
    rng = np.random.default_rng(11)
    a, b = (Var("advice", i, 0) for i in range(2))
    expr = (a * b + a) * (a * b) - b
    cols = {i: torch.as_tensor(_fp_values(rng, 64).astype(np.int32)) for i in range(2)}
    made = []

    def keep(t):
        made.append(weakref.ref(t))
        return t

    gc.collect()
    gc.disable()
    try:
        out = evaluate(expr, var=lambda kind, i, rot: cols[i],
                       const=lambda v: FP.const(v, 1, "cpu"),
                       add=lambda x, y: keep(FP.add(x, y)),
                       mul=lambda x, y: keep(FP.mul(x, y)),
                       neg=lambda x: keep(FP.neg(x)))
        assert len(made) == 6  # three products, two sums, one negation
        alive = [r for r in made if r() is not None and r() is not out]
    finally:
        gc.enable()
    assert alive == []


def _forge_load_value(fp, circ, asg):
    """m_value + 1 on the last load row of the memory table (either
    package)."""
    adv = circ.tcs.col.advice
    loads = np.nonzero(np.array(fp.decode(asg.get(adv["m_load"]))))[0]
    row = int(loads[-1])
    vals = fp.decode(asg.get(adv["m_value"]))
    vals[row] = (vals[row] + 1) % fp.modulus
    asg.set(adv["m_value"], np.array(vals, dtype=object))
    return asg


def test_config3_program_mock_matches_jax():
    report = prove_config(3, 8, mock=True, prove=False, device="cpu",
                          cache_dir=None, word_bits=16, k=10, log=lambda m: None)
    assert report["mock_failures"] == []
    assert report["steps"] == 249 and report["accesses"] > 0
    objects = report["objects"]
    circ, asg = objects["circ"], objects["asg"]

    jcirc = JCircuit(16, 8, k=10)
    jtrace = jeval(jconfig3(1 << 8, word_bits=16), 16, 8)
    jasg = jcirc.assignment(jtrace)
    assert jplonk.MockProver(jcirc.tcs.cs, jasg).verify() == []

    forged = [str(f) for f in MockProver(circ.tcs.cs,
                                         _forge_load_value(FP, circ, asg)).verify()]
    jforged = [str(f) for f in jplonk.MockProver(
        jcirc.tcs.cs, _forge_load_value(JFP, jcirc, jasg)).verify()]
    assert forged and forged == jforged
