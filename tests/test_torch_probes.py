"""The port's op-rate probes P1 and P2 (tinyram_tpu_torch.probes) against the
JAX package's kernel bodies.

The Pallas bodies of scripts/bench_vpu.py (`make_kernel`) and
scripts/bench_vpu_ops.py (`_kernel_factory`) are loaded with importlib and
run eagerly on jnp arrays with a numpy output buffer as `o_ref`, as
tests/test_pallas_point.py runs Pallas bodies.  The port's wrappers, given
CPU tensors, run their plain versions on the same inputs.  Small shapes and
short chains (reps <= 64).  Tolerance: exact for the u32 ops and f32mul;
rtol 1e-6 for f32fma (x·b + a, each step rounded).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyram_tpu_torch import probes

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "scripts")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_vpu():
    return _load("bench_vpu")


@pytest.fixture(scope="module")
def bench_vpu_ops():
    return _load("bench_vpu_ops")


def _run_body(body, a, b, dtype):
    out = np.zeros(a.shape, dtype=dtype)
    body(jnp.asarray(a), jnp.asarray(b), out)
    return out


@pytest.mark.parametrize("reps", [16, 64])
@pytest.mark.parametrize("op", probes.P1_OPS)
def test_p1_plain_equals_jax_body(bench_vpu, op, reps):
    a, b = probes.p1_inputs(shape=(16, 256), seed=reps, device="cpu")
    want = _run_body(bench_vpu.make_kernel(op, reps), a.numpy().view(np.uint32),
                     b.numpy().view(np.uint32), np.uint32)
    before = probes.vpu_chain.launches
    got = probes.vpu_chain(op, a, b, reps)
    assert probes.vpu_chain.launches == before  # CPU: no kernel launch
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("op", probes.P2_OPS)
def test_p2_plain_equals_jax_body(bench_vpu_ops, monkeypatch, op):
    reps = 16
    monkeypatch.setattr(bench_vpu_ops, "REPS", reps)
    a, b = probes.p2_inputs(op, shape=(64, 128), seed=7, device="cpu")
    if op in probes.F32_OPS:
        want = _run_body(bench_vpu_ops._kernel_factory(op), a.numpy(),
                         b.numpy(), np.float32)
        got = probes.vpu_ops(op, a, b, reps).numpy()
        assert np.isfinite(got).all()
        if op == "f32mul":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        want = _run_body(bench_vpu_ops._kernel_factory(op),
                         a.numpy().view(np.uint32), b.numpy().view(np.uint32),
                         np.uint32)
        got = probes.vpu_ops(op, a, b, reps)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_f32_chains_reach_inf_as_in_jax():
    """At the JAX script's 256 steps the f32 chains from [1, 2) overflow:
    x·b from x = b = a is a^257, past 3.4e38 once a > ~1.41."""
    a, b = probes.p2_inputs("f32mul", shape=(2, 128), device="cpu")
    for op in probes.F32_OPS:
        out = probes.vpu_ops(op, a, b)
        assert torch.isinf(out[a > 1.5]).all()
        assert torch.isfinite(out[a < 1.3]).all()


def test_u32_mul_wraps_like_uint32():
    x = torch.tensor([0x7FFFFFFF, -1, 0x12345678, 1 << 16], dtype=torch.int32)
    y = torch.tensor([3, -1, 0x9ABCDEF0 - (1 << 32), 1 << 16], dtype=torch.int32)
    want = (x.numpy().view(np.uint32).astype(np.uint64)
            * y.numpy().view(np.uint32).astype(np.uint64)) & 0xFFFFFFFF
    got = probes.chain_plain("mul", x, y, 1).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_wrappers_reject_what_the_kernel_does_not_take():
    a, b = probes.p1_inputs(shape=(2, 8), device="cpu")
    with pytest.raises(ValueError):
        probes.vpu_chain("f32mul", a, b, 16)
    with pytest.raises(ValueError):
        probes.vpu_chain("mul", a, b, 17)
    with pytest.raises(TypeError):
        probes.vpu_ops("f32mul", a, b, 16)
    with pytest.raises(TypeError):
        probes.vpu_chain("add", a, b[:1], 16)
