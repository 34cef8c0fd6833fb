"""The plain reference: its constants, its emulator and its verifier against
the port at W = 8, and the boundary that keeps the port out of it."""

import ast
import glob
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import constants, emulator, isa
from benchmark.reference.verifier import Verifier
from benchmark.spec import HERE, ROOT
from benchmark.tests.support import DATA

torch.set_num_threads(1)

PROG = [("Mov", 1, None, ("imm", 5)), ("StoreW", 1, None, ("imm", 3)),
        ("LoadW", 2, None, ("imm", 3)), ("Add", 3, 2, ("imm", 7)),
        ("Xor", 3, 3, ("reg", 1)), ("Answer", None, None, ("reg", 3))]
W8 = {"word_bits": 8, "reg_count": 8, "k": 6}


class _Rng:
    def __init__(self, seed):
        self._r = random.Random(seed)

    def randbelow(self, n):
        return self._r.randrange(n)


def _ref(prog):
    return [isa.Instruction(op, ri, rj, isa.Imm(v) if kind == "imm"
                            else isa.Reg(v)) for op, ri, rj, (kind, v) in prog]


@pytest.fixture(scope="module")
def port_w8():
    from tinyram_tpu_torch.ipa import setup
    from tinyram_tpu_torch.tinyram import TinyRamCircuit

    circ = TinyRamCircuit(8, 8)
    srs = setup(circ.k, device="cpu")
    return circ, srs, circ.keygen(srs)


@pytest.fixture(scope="module")
def w8_constants(tmp_path_factory):
    path = tmp_path_factory.mktemp("w8") / "w8.json"
    path.write_text("{}")
    data = constants.compute(8, 8, 6, log=lambda *a: None)
    import json

    with open(constants.path_for(str(path)), "w") as f:
        json.dump(data, f)
    return str(path), data


def test_constants_equal_the_ports_key_and_instance_commitments(port_w8,
                                                                 w8_constants):
    from tinyram_tpu_torch.plonk.verifier import _instance_commitments
    from tinyram_tpu_torch.poly.domain import domain_cache

    circ, srs, pk = port_w8
    c = constants.Constants(w8_constants[1])
    assert pk.vk.fixed_commitments == c.fixed
    n = 64
    cols = []
    for i in range(3):
        v = np.zeros(n, dtype=np.int64)
        v[i] = 1
        cols.append(v)
    _, comms = _instance_commitments(srs, domain_cache("Fp", 6, 8, srs.device),
                                     cols, 64)
    assert comms == c.lagrange[:3]


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_reference_emulator_equals_the_native_one(name):
    import json

    from benchmark import programs
    from benchmark.harness import compare_traces
    from tinyram_tpu_torch.tinyram.isa import Imm, Instruction, Reg
    from tinyram_tpu_torch.tinyram.native import eval_program_native

    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    prog = programs.Client(cfg, {}, 2**31 + 11).program(0)
    port = eval_program_native(
        [Instruction(op, ri, rj, Imm(v) if kind == "imm" else Reg(v))
         for op, ri, rj, (kind, v) in prog], cfg["word_bits"], 8)
    ref = emulator.eval_program(_ref(prog), cfg["word_bits"], 8)
    assert compare_traces(port, ref) == []
    ref.answer += 1
    assert compare_traces(port, ref) == ["answer"]


def test_reference_verifier_judges_a_port_proof(port_w8, w8_constants):
    from tinyram_tpu_torch.plonk import create_proof
    from tinyram_tpu_torch.tinyram import eval_program
    from tinyram_tpu_torch.tinyram.isa import Imm, Instruction, Reg

    circ, srs, pk = port_w8
    port_prog = [Instruction(op, ri, rj, Imm(v) if kind == "imm" else Reg(v))
                 for op, ri, rj, (kind, v) in PROG]
    tr = eval_program(port_prog, 8, 8)
    proof = create_proof(srs, pk, circ.assignment(tr, "cpu"), rng=_Rng(1))
    ver = Verifier(W8, w8_constants[0])
    prog = _ref(PROG)
    answer = emulator.eval_program(prog, 8, 8).answer
    assert answer == tr.answer
    flipped = bytearray(proof)
    flipped[len(proof) // 2] ^= 1
    verdicts = ver.check([(prog, answer, proof), (prog, answer + 1, proof),
                          (prog, answer, bytes(flipped)),
                          (prog, answer, proof[:-32])])
    assert verdicts[0] == ""
    assert all(verdicts[1:]), verdicts
    assert ver.check([(prog, answer, proof)] * 2) == ["", ""]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port_or_jax():
    files = glob.glob(os.path.join(HERE, "reference", "*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("tinyram_tpu_torch", "tinyram_tpu",
                                              "jax", "jaxlib", "flax", "torch"), (path, name)
    code = ("import sys, pkgutil, importlib, benchmark.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('benchmark.reference.' + m.name)\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = eval(out)
    for name in ("tinyram_tpu_torch", "tinyram_tpu", "jax", "torch"):
        assert name not in loaded


def test_the_committed_constants_belong_to_their_configs():
    import json

    for name in ("config2", "config3"):
        cfg_file = os.path.join(HERE, "configs", f"{name}.json")
        with open(cfg_file) as f:
            cfg = json.load(f)
        with open(constants.path_for(cfg_file)) as f:
            data = json.load(f)
        assert (data["word_bits"], data["reg_count"], data["k"]) == \
            (cfg["word_bits"], cfg["reg_count"], cfg["k"])
        assert len(data["fixed"]) == 31 and len(data["lagrange"]) == constants.LINES
    assert os.path.exists(os.path.join(DATA, "w8.json"))
