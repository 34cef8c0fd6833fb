"""The port's MockProver (tinyram_tpu_torch.plonk.mock) against the JAX package's.

The same assignments go through both mock provers and their `Failure`
lists must be equal: the same kind, name and detail, in the same order.
Cases: the toy circuit of tests/test_plonk.py (k=3) clean and with its
four tampers (gate, fixed lookup, dynamic lookup, copy), the W=8 TinyRAM
circuit clean, and forged witnesses of tests/test_proof_negative.py.  Then
the port alone on all 13 forged families: each trips a failure named after
its family.  The port runs on the CPU (B1's plain version).
"""

import numpy as np
import pytest
import torch

import tinyram_tpu.plonk as jplonk
import tinyram_tpu_torch.plonk as tplonk
from tinyram_tpu.field import FP as JFP
from tinyram_tpu.tinyram import Imm as JImm
from tinyram_tpu.tinyram import Instruction as JInstruction
from tinyram_tpu.tinyram import Reg as JReg
from tinyram_tpu.tinyram import TinyRamCircuit as JCircuit
from tinyram_tpu.tinyram import eval_program as jeval
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.tinyram import Imm, Instruction, Reg, TinyRamCircuit, eval_program

from test_proof_negative import FAMILY_PAYLOADS
from test_proof_negative import _forged_assignment as jax_forged

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

K = 3
N = 1 << K
TAMPERS = [None, "mul", "rng", "dyn", "copy"]


def toy(plonk, tamper=None, **device):
    """tests/test_plonk.py's circuit and assignment, built with the classes
    of `plonk` (either package); returns (cs, asg, instance values)."""
    cs = plonk.ConstraintSystem()
    q_mul = cs.fixed_column("q_mul")
    q_pub = cs.fixed_column("q_pub")
    q_rng = cs.fixed_column("q_rng")
    t_rng = cs.fixed_column("t_rng")
    a = cs.advice_column("a")
    b = cs.advice_column("b")
    c = cs.advice_column("c")
    d_tbl = cs.advice_column("d_tbl")
    s_tbl = cs.fixed_column("s_tbl")
    q_dyn = cs.fixed_column("q_dyn")
    inst = cs.instance_column("pub")
    cs.gate("mul", q_mul.cur() * (a.cur() * b.cur() - c.cur()))
    cs.gate("pub", q_pub.cur() * (a.cur() - inst.cur()))
    cs.lookup("rng", [q_rng.cur() * a.cur()], [t_rng.cur()])
    cs.lookup("dyn", [q_dyn.cur() * b.cur()], [s_tbl.cur() * d_tbl.cur()])
    cs.copy(a, 2, c, 0)

    asg = plonk.Assignment(cs, N, **device)
    a_v = [7, 3, 42, 5, 0, 0, 0, 0]
    b_v = [6, 4, 1, 2, 9, 9, 0, 0]
    c_v = [42, 12, 42, 10, 0, 0, 0, 0]
    if tamper == "mul":
        c_v[1] = 13
    if tamper == "copy":
        a_v[2] = 41
        c_v[2] = 41
    asg.set(q_mul, [1, 1, 1, 1, 0, 0, 0, 0])
    asg.set(q_pub, [1, 0, 0, 0, 0, 0, 0, 0])
    asg.set(q_rng, [1, 1, 1, 1, 0, 0, 0, 0])
    asg.set(t_rng, [7, 3, 42, 4, 0, 0, 0, 0] if tamper == "rng"
            else [7, 3, 42, 5, 0, 0, 0, 0])
    asg.set(a, a_v)
    asg.set(b, b_v)
    asg.set(c, c_v)
    asg.set(d_tbl, [6, 4, 1, 2, 8, 0, 0, 0] if tamper == "dyn"
            else [6, 4, 1, 2, 9, 0, 0, 0])
    asg.set(s_tbl, [1, 1, 1, 1, 1, 0, 0, 0])
    asg.set(q_dyn, [1, 1, 1, 1, 1, 1, 0, 0])
    inst_v = [7, 0, 0, 0, 0, 0, 0, 0]
    asg.set(inst, inst_v)
    return cs, asg, inst_v


def _as_tuples(failures):
    return [(f.kind, f.name, f.detail) for f in failures]


@pytest.mark.parametrize("tamper", TAMPERS, ids=[str(t) for t in TAMPERS])
def test_toy_failures_equal_jax(tamper):
    want = jplonk.MockProver(*toy(jplonk, tamper)[:2]).verify()
    got = tplonk.MockProver(*toy(tplonk, tamper, device="cpu")[:2]).verify()
    assert _as_tuples(got) == _as_tuples(want)
    assert [str(f) for f in got] == [str(f) for f in want]
    assert bool(got) == (tamper is not None)


def _program(I, R, A):
    return [I("Mov", 2, None, A(55)), I("Shr", 3, 2, A(2)), I("Answer", None, None, R(3))]


@pytest.fixture(scope="module")
def w8():
    jcirc, tcirc = JCircuit(8, 8), TinyRamCircuit(8, 8)
    jtr = jeval(_program(JInstruction, JReg, JImm), 8, 8)
    ttr = eval_program(_program(Instruction, Reg, Imm), 8, 8)
    return jcirc, jtr, tcirc, ttr


def port_forged(circ, tr, family, payload):
    """tests/test_proof_negative.py's forgery on the port's assignment:
    activate `out.<family>` on the first padding row and apply the payload."""
    row = len(tr) + 1
    asg = circ.assignment(tr, device="cpu")
    for name, off, value in [(f"out.{family}", 0, 1)] + payload:
        col = circ.tcs.col.advice[name]
        vals = FP.decode(asg.get(col))
        vals[row + off] = value
        asg.set(col, np.array(vals, dtype=object))
    return asg


def test_w8_clean_equal_jax(w8):
    jcirc, jtr, tcirc, ttr = w8
    assert jcirc.mock_prove(jtr) == []
    assert tcirc.mock_prove(ttr, device="cpu") == []


SHARED = ["and", "sum", "flag1", "flag4"]


@pytest.mark.parametrize("family", SHARED)
def test_w8_forged_failures_equal_jax(w8, family):
    jcirc, jtr, tcirc, ttr = w8
    payload = dict(FAMILY_PAYLOADS)[family]
    want = jplonk.MockProver(jcirc.tcs.cs,
                             jax_forged(jcirc, jtr, family, payload)).verify()
    got = tplonk.MockProver(tcirc.tcs.cs,
                            port_forged(tcirc, ttr, family, payload)).verify()
    assert want and _as_tuples(got) == _as_tuples(want)


@pytest.mark.parametrize("family,payload", FAMILY_PAYLOADS,
                         ids=[f for f, _ in FAMILY_PAYLOADS])
def test_port_names_every_forged_family(w8, family, payload):
    _, _, circ, tr = w8
    fails = tplonk.MockProver(circ.tcs.cs,
                              port_forged(circ, tr, family, payload)).verify()
    assert any(f.name.split("#")[0].split(".")[0].startswith(family)
               for f in fails), [f.name for f in fails]


def test_assignment_values_equal_jax(w8):
    """The forged assignment itself is the same column for column."""
    jcirc, jtr, tcirc, ttr = w8
    fam, payload = FAMILY_PAYLOADS[0]
    ja = jax_forged(jcirc, jtr, fam, payload)
    ta = port_forged(tcirc, ttr, fam, payload)
    for kind in ("fixed", "advice", "instance"):
        for j, t in zip(getattr(ja, kind), getattr(ta, kind)):
            np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                          np.asarray(j).astype(np.int64))
    assert JFP.modulus == FP.modulus
