"""The port's TinyRAM slice as a whole at W=8 (k=6), against recorded JAX output.

A live JAX proof takes minutes on a CPU (XLA compiles), so the JAX side is
the fixture tests/data/torch_golden_w8.npz, made by scripts/torch_golden.py
from the JAX package: its fixed columns, vk commitments and two proofs made
under seeded random streams.  Tolerance 0 throughout: keys, commitments and
proof bytes must be equal.

This file: keygen and the carried-over proving key, the verifier on the
recorded Answer-only proof, and the import boundary (the port never loads
JAX).  The proofs themselves are made in test_torch_proof_answer.py and
test_torch_proof_memory.py, the rejections in test_torch_proof_reject.py,
one file each so that the test workers run them side by side.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tinyram_tpu_torch.convert import limbs, pk_from_numpy, points_from_bytes
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.tinyram import Imm, Instruction, TinyRamCircuit

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_w8.npz")
ANSWER = [Instruction("Answer", None, None, Imm(0))]


@pytest.fixture(scope="module")
def golden():
    rec = dict(np.load(GOLDEN))
    rec["fixed_commitments"] = points_from_bytes(rec["fixed_comm"],
                                                 rec["fixed_comm_none"])
    return rec


@pytest.fixture(scope="module")
def circuit():
    return TinyRamCircuit(8, 8)


@pytest.fixture(scope="module")
def keys(circuit):
    srs = setup(circuit.k, device="cpu")
    return srs, circuit.keygen(srs)


def test_keygen_matches_recorded_vk(golden, circuit, keys):
    _, pk = keys
    assert circuit.k == int(golden["k"])
    assert pk.vk.fixed_commitments == golden["fixed_commitments"]
    assert pk.vk.sigma_commitments == [] and pk.sigma_lag == []
    for name in ("fixed_lag", "fixed_coeff"):
        want = golden[name].astype(np.int64)
        got = np.stack([c.numpy() for c in getattr(pk, name)]).astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_pk_from_numpy_equals_port_keygen(golden, circuit, keys):
    _, pk = keys
    carried = pk_from_numpy(golden, circuit.tcs.cs, device="cpu")
    assert (carried.vk.k, carried.vk.extended_k) == (pk.vk.k, pk.vk.extended_k)
    assert carried.vk.fixed_commitments == pk.vk.fixed_commitments
    assert carried.vk.perm_columns == pk.vk.perm_columns
    for name in ("fixed_lag", "fixed_coeff", "sigma_lag", "sigma_coeff"):
        a, b = getattr(carried, name), getattr(pk, name)
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name
    assert limbs(golden["fixed_lag"][0], "cpu").dtype == torch.int32


def test_verifier_accepts_jax_answer_proof_and_rejects_flipped_byte(
        golden, circuit, keys):
    srs, pk = keys
    proof = golden["proof_answer"].tobytes()
    assert circuit.verify(srs, pk, ANSWER, 0, proof)
    flipped = bytearray(proof)
    flipped[len(proof) // 2] ^= 0x01
    assert not circuit.verify(srs, pk, ANSWER, 0, bytes(flipped))


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tinyram_tpu_torch\n"
        "import tinyram_tpu_torch.tinyram.circuit\n"
        "import tinyram_tpu_torch.plonk.mock, tinyram_tpu_torch.plonk.batch\n"
        "import tinyram_tpu_torch.plonk.serialize, tinyram_tpu_torch.plonk.layout\n"
        "import tinyram_tpu_torch.tinyram.mem, tinyram_tpu_torch.probes\n"
        "for m in pkgutil.walk_packages(tinyram_tpu_torch.__path__,"
        " 'tinyram_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules"
        " if m == 'jax' or m.startswith(('jax.', 'tinyram_tpu.'))"
        " or m == 'tinyram_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_measuring_entry_points_never_import_jax():
    """`entry`, `bench` and `verify_msm` load neither JAX nor the JAX
    package, and `chip_smoke.py` and the sweep helpers it runs name neither
    in any import (read from their source: their imports sit inside
    functions that need a card)."""
    code = (
        "import sys\n"
        "import tinyram_tpu_torch.entry, tinyram_tpu_torch.bench\n"
        "import tinyram_tpu_torch.verify_msm\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules"
        " if m == 'jax' or m.startswith(('jax.', 'tinyram_tpu.'))"
        " or m == 'tinyram_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    for path in ("chip_smoke.py", os.path.join("scripts", "torch_point_sweep.py")):
        with open(os.path.join(ROOT, path)) as f:
            tree = ast.parse(f.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert "tinyram_tpu_torch.entry" in names or path != "chip_smoke.py"
        assert not [m for m in names
                    if m.split(".")[0] in ("jax", "tinyram_tpu")], path
