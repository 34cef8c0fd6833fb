"""The port's native emulator (tinyram_tpu_torch.tinyram.native) against the
port's Python emulator and the JAX package's native one, on the CPU.

Traces must be equal field for field (tolerance 0): `config3_program` (the
full ISA with memory, BASELINE config 3's program) at 2^8-2^10 steps and
W = 16/24, a program reading the primary tape, and random straight-line
ALU programs at W = 8/16.  The library is built with g++ under the
checkout's build/native/; a failed build raises, and so does a missing
compiler.
"""

import os
import random

import numpy as np
import pytest
import torch

from tinyram_tpu.tinyram.bench_programs import config3_program as jconfig3
from tinyram_tpu.tinyram.native import eval_program_native as jnative
from tinyram_tpu_torch.tinyram import Imm, Instruction, Reg, eval_program
from tinyram_tpu_torch.tinyram import native
from tinyram_tpu_torch.tinyram.bench_programs import config3_program
from tinyram_tpu_torch.tinyram.isa import HAS_RI_ONLY, HAS_RI_RJ
from tinyram_tpu_torch.tinyram.native import eval_program_native
from tinyram_tpu_torch.tinyram.prove_config import trace_mismatch

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

MAX_STEPS = 1 << 12  # room for 2^10 steps; the default sizes buffers for 2^22


def I(op, ri=None, rj=None, a=0, areg=None):
    return Instruction(op, ri, rj, Reg(areg) if areg is not None else Imm(a))


@pytest.mark.parametrize("steps_log2,word_bits", [(8, 16), (9, 24), (10, 16),
                                                  (10, 24)])
def test_config3_program_traces_equal(steps_log2, word_bits):
    prog = config3_program(1 << steps_log2, word_bits=word_bits)
    py = eval_program(prog, word_bits, 8)
    nat = eval_program_native(prog, word_bits, 8, max_steps=MAX_STEPS)
    assert trace_mismatch(py, nat) == []
    assert len(nat) > (1 << steps_log2) - 20 and len(nat.accesses) > 0
    jax_nat = jnative(jconfig3(1 << steps_log2, word_bits=word_bits), word_bits,
                      8, max_steps=MAX_STEPS)
    assert trace_mismatch(nat, jax_nat) == []


def test_tape_program_traces_equal():
    prog = [
        I("LoadW", ri=0, a=0),
        I("Add", ri=1, rj=0, a=200),
        I("StoreW", ri=1, a=8),
        I("LoadW", ri=2, a=8),
        I("Shl", ri=3, rj=2, a=2),
        I("Cmpg", ri=3, a=5),
        I("CJmp", a=8),
        I("Answer", areg=3),
        I("Answer", areg=1),
    ]
    py = eval_program(prog, 8, 8, primary_tape=[99])
    nat = eval_program_native(prog, 8, 8, primary_tape=[99], max_steps=MAX_STEPS)
    assert trace_mismatch(py, nat) == []
    assert nat.primary_tape == (99,)


@pytest.mark.parametrize("word_bits", [8, 16])
def test_random_programs_traces_equal(word_bits):
    """Straight-line programs over the full ALU (no jumps, so they end)."""
    rng = random.Random(1234 + word_bits)
    alu = sorted((HAS_RI_RJ | HAS_RI_ONLY) - {"LoadW", "StoreW", "CMov"})
    mask = (1 << word_bits) - 1
    for _ in range(10):
        prog = []
        for _ in range(rng.randrange(1, 30)):
            op = rng.choice(alu)
            a = Imm(rng.randrange(mask + 1)) if rng.random() < 0.5 \
                else Reg(rng.randrange(8))
            prog.append(Instruction(op, rng.randrange(8),
                                    rng.randrange(8) if op in HAS_RI_RJ else None,
                                    a))
        prog.append(I("Answer", areg=0))
        py = eval_program(prog, word_bits, 8)
        nat = eval_program_native(prog, word_bits, 8, max_steps=MAX_STEPS)
        assert trace_mismatch(py, nat) == []


def test_bad_programs_raise():
    with pytest.raises(ValueError, match="does not fit"):
        eval_program_native([I("Mov", ri=0, a=256), I("Answer", a=0)], 8, 8,
                            max_steps=MAX_STEPS)
    with pytest.raises(ValueError, match="did not Answer"):
        eval_program_native([I("Jmp", a=0)], 8, 8, max_steps=64)


def test_library_builds_under_the_checkout():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.BUILD_DIR == os.path.join(root, "build", "native")
    path = native.build()
    assert os.path.dirname(os.path.dirname(path)) == native.BUILD_DIR
    assert native.native_available()


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "emulator.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        eval_program_native([I("Answer", a=0)], 8, 8, max_steps=MAX_STEPS)
    assert not native.native_available()
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_trace_mismatch_names_the_field():
    prog = config3_program(1 << 8, word_bits=16)
    py = eval_program(prog, 16, 8)
    nat = eval_program_native(prog, 16, 8, max_steps=MAX_STEPS)
    nat.regs[5, 2] ^= 1
    nat.accesses[3].value ^= 1
    assert trace_mismatch(py, nat) == ["regs", "accesses"]
    assert np.array_equal(py.pc, nat.pc)
