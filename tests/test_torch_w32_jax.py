"""BASELINE config 3 at its 32-bit word (W = 32, 8 registers, k = 18) held
against the JAX package, which the port follows, on the CPU: the port's
native emulator against the JAX package's `eval_program`, and the port's
`exe_witness` against the JAX package's, column for column, on the seeded
programs of `config3w32`'s class and the programs at the word's edges of
`tests/test_torch_w32.py` (which holds the same port against the
benchmark's plain reference and imports no JAX).
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_w32 import (  # noqa: E402
    DRAWS, EDGES, K, R, W, WITNESS_PROGRAM, _class_program, _port)
from tinyram_tpu.tinyram import Imm as JImm  # noqa: E402
from tinyram_tpu.tinyram import Instruction as JInstruction  # noqa: E402
from tinyram_tpu.tinyram import Reg as JReg  # noqa: E402
from tinyram_tpu.tinyram import eval_program as jeval  # noqa: E402
from tinyram_tpu.tinyram.exe import TinyRamCS as JTinyRamCS  # noqa: E402
from tinyram_tpu.tinyram.exe import exe_witness as jexe_witness  # noqa: E402
from tinyram_tpu_torch.tinyram.exe import TinyRamCS, exe_witness  # noqa: E402
from tinyram_tpu_torch.tinyram.native import eval_program_native  # noqa: E402
from tinyram_tpu_torch.tinyram.prove_config import trace_mismatch  # noqa: E402


def _jax(prog):
    return [JInstruction(op, ri, rj, JImm(v) if kind == "imm" else JReg(v))
            for op, ri, rj, (kind, v) in prog]


PROGRAMS = {**{f"class_{s}_{seed}": (s, seed) for s, seed in DRAWS},
            **{f"edge_{name}": name for name in EDGES}}


def _program(key):
    which = PROGRAMS[key]
    return _class_program(*which) if isinstance(which, tuple) else EDGES[which]


@pytest.mark.parametrize("key", sorted(PROGRAMS))
def test_native_emulator_equals_the_jax_emulator(key):
    prog = _program(key)
    port = eval_program_native(_port(prog), W, R)
    assert trace_mismatch(port, jeval(_jax(prog), W, R)) == []


@pytest.mark.parametrize("key", ["witness", "class_10_2",
                                 "class_10_3190000101"])
def test_exe_witness_equals_the_jax_witness(key):
    """Every advice column at (32, 8, 18), bit for bit, of the traces the
    two emulators make of one program."""
    prog = WITNESS_PROGRAM if key == "witness" else _program(key)
    port = exe_witness(TinyRamCS(W, R, k=K),
                       eval_program_native(_port(prog), W, R))
    ref = jexe_witness(JTinyRamCS(W, R, k=K), jeval(_jax(prog), W, R))
    assert set(port) == set(ref)
    assert [name for name in sorted(ref)
            if not np.array_equal(np.asarray(port[name]),
                                  np.asarray(ref[name]))] == []
