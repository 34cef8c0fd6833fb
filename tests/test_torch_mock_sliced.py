"""The port's MockProver with its passes cut small, against the JAX mock.

`plonk.mock` evaluates the gate check in passes of polynomials and the
lookup and LogUp checks in row slices of at most `EVAL_ELEMENTS` values
(config 4's 2^21-row witness does not fit the card in one pass).  Here
`EVAL_ELEMENTS` is patched down so that every check runs in many passes
and slices, and the `Failure` lists must still equal the JAX package's:
the toy circuit of tests/test_plonk.py and its four tampers, the W=8
circuit clean and with each of the 13 forged families of
tests/test_proof_negative.py.  At W=8 the forged row is 4 and the `out`
lookup has 38 expressions, one of them rotated by +1: with 152 elements its
slices are 4 rows, so the forged row opens a slice and row 3 reads it
across the edge.  The slices themselves are held against the whole-column
evaluation with rotations across every edge.  The port runs on the CPU.
"""

import numpy as np
import pytest
import torch

import tinyram_tpu.plonk as jplonk
import tinyram_tpu_torch.plonk as tplonk
from tinyram_tpu.tinyram import Imm as JImm
from tinyram_tpu.tinyram import Instruction as JInstruction
from tinyram_tpu.tinyram import Reg as JReg
from tinyram_tpu.tinyram import TinyRamCircuit as JCircuit
from tinyram_tpu.tinyram import eval_program as jeval
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.plonk import mock
from tinyram_tpu_torch.plonk.prover import _eval_exprs_on
from tinyram_tpu_torch.tinyram import Imm, Instruction, Reg, TinyRamCircuit, eval_program

from test_proof_negative import FAMILY_PAYLOADS
from test_proof_negative import _forged_assignment as jax_forged
from test_torch_mock import TAMPERS, _as_tuples, _program, port_forged, toy

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

OUT_EDGE = 38 * 4  # W=8: the `out` lookup's 38 expressions x 4 rows


@pytest.fixture(scope="module")
def w8():
    jcirc, tcirc = JCircuit(8, 8), TinyRamCircuit(8, 8)
    jtr = jeval(_program(JInstruction, JReg, JImm), 8, 8)
    ttr = eval_program(_program(Instruction, Reg, Imm), 8, 8)
    return jcirc, jtr, tcirc, ttr


@pytest.mark.parametrize("elements", [1, 5])
@pytest.mark.parametrize("tamper", TAMPERS, ids=[str(t) for t in TAMPERS])
def test_toy_sliced_failures_equal_jax(monkeypatch, tamper, elements):
    want = jplonk.MockProver(*toy(jplonk, tamper)[:2]).verify()
    monkeypatch.setattr(mock, "EVAL_ELEMENTS", elements)
    got = tplonk.MockProver(*toy(tplonk, tamper, device="cpu")[:2]).verify()
    assert _as_tuples(got) == _as_tuples(want)
    assert bool(got) == (tamper is not None)


def test_w8_sliced_clean(monkeypatch, w8):
    _, _, tcirc, ttr = w8
    monkeypatch.setattr(mock, "EVAL_ELEMENTS", OUT_EDGE)
    assert tcirc.mock_prove(ttr, device="cpu") == []


@pytest.mark.parametrize("family,payload", FAMILY_PAYLOADS,
                         ids=[f for f, _ in FAMILY_PAYLOADS])
def test_w8_sliced_forged_failures_equal_jax(monkeypatch, w8, family,
                                             payload):
    jcirc, jtr, tcirc, ttr = w8
    want = jplonk.MockProver(jcirc.tcs.cs,
                             jax_forged(jcirc, jtr, family, payload)).verify()
    monkeypatch.setattr(mock, "EVAL_ELEMENTS", OUT_EDGE)
    asg = port_forged(tcirc, ttr, family, payload)
    assert len(ttr) + 1 == 4  # the forged row opens the `out` slice [4, 8)
    got = tplonk.MockProver(tcirc.tcs.cs, asg).verify()
    assert want and _as_tuples(got) == _as_tuples(want)


@pytest.mark.parametrize("rows_per_slice", [1, 3, 7, 16])
def test_slices_equal_the_whole_column(monkeypatch, rows_per_slice):
    """`_decode_sliced` of expressions rotated by -1, 0 and +1 equals
    their whole-column evaluation: each slice reads its neighbours' rows
    across its edges, and the first and last slices wrap around."""
    cs = tplonk.ConstraintSystem()
    a, b = cs.advice_column("a"), cs.advice_column("b")
    n = 16
    asg = tplonk.Assignment(cs, n, device="cpu")
    gen = np.random.default_rng(5)
    asg.set(a, gen.integers(0, 1 << 20, size=n))
    asg.set(b, gen.integers(0, 1 << 20, size=n))
    exprs = [a.cur() * b.next(), a.prev() + b.cur(), b.next() * b.next(),
             a.cur() - b.prev(), a.next() * a.prev() + 3]
    whole = np.array([FP.decode(v) for v in _eval_exprs_on(
        exprs, lambda kind, i: asg.fetch(kind, i))], dtype=object)
    monkeypatch.setattr(mock, "EVAL_ELEMENTS", rows_per_slice * len(exprs))
    got = mock._decode_sliced(exprs, asg, n)
    assert got.dtype == object  # a - b wraps below 0: values beyond 62 bits
    np.testing.assert_array_equal(got, whole)
    small = [a.cur() + b.next(), b.prev()]
    monkeypatch.setattr(mock, "EVAL_ELEMENTS", rows_per_slice * len(small))
    got = mock._decode_sliced(small, asg, n - 3)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.array(
        [FP.decode(v)[: n - 3] for v in _eval_exprs_on(
            small, lambda kind, i: asg.fetch(kind, i))], dtype=np.int64))
