"""The port's memory-consistency table (tinyram_tpu_torch.tinyram.mem) against
the JAX package's: the witness of MemCS(8) column for column, and the three
mock cases of tests/test_mem.py (clean, a changed load value, unsorted
addresses) with equal Failure lists.  The port runs on the CPU.
"""

import numpy as np
import pytest
import torch

import tinyram_tpu.plonk as jplonk
import tinyram_tpu.tinyram as jtinyram
import tinyram_tpu_torch.plonk as tplonk
import tinyram_tpu_torch.tinyram as ttinyram
from tinyram_tpu.field import FP as JFP
from tinyram_tpu.tinyram.mem import MemCS as JMemCS
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.tinyram.mem import MemCS

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them


def _trace(t):
    """tests/test_mem.py's program with memory traffic, in package `t`."""
    def I(op, ri=None, rj=None, a=0, areg=None):
        return t.Instruction(op, ri, rj, t.Reg(areg) if areg is not None else t.Imm(a))

    prog = [
        I("LoadW", ri=0, a=0),
        I("Add", ri=1, rj=0, a=1),
        I("StoreW", ri=1, a=8),
        I("LoadW", ri=2, a=8),
        I("StoreW", ri=2, a=0),
        I("Answer", areg=2),
    ]
    return t.eval_program(prog, 8, 8, primary_tape=[41])


def _tamper(mcs, asg, fp, case):
    """tests/test_mem.py's two tampers, applied through `fp` (either package)."""
    def col(name):
        return fp.decode(asg.get(mcs.advice[name]))

    if case == "load_value":
        loads = np.nonzero(np.array(col("load")))[0]
        row = int(loads[-1])
        ints = col("value")
        ints[row] = (ints[row] + 1) % 251
        asg.set(mcs.advice["value"], np.array(ints, dtype=np.int64))
    elif case == "unsorted":
        addr = col("address")
        j = next(i for i in range(1, len(addr)) if addr[i] != addr[i - 1])
        addr[j - 1], addr[j] = addr[j], addr[j - 1]
        asg.set(mcs.advice["address"], np.array(addr, dtype=np.int64))
    return asg


@pytest.fixture(scope="module")
def witnesses():
    jm, tm = JMemCS(8), MemCS(8)
    return jm, tm


def test_witness_equal_jax(witnesses):
    jm, tm = witnesses
    ja = jm.witness(_trace(jtinyram))
    ta = tm.witness(_trace(ttinyram), device="cpu")
    assert (tm.k, tm.n, tm.cs.num_advice, tm.cs.num_fixed) == \
        (jm.k, jm.n, jm.cs.num_advice, jm.cs.num_fixed)
    for kind in ("fixed", "advice"):
        for i, (j, t) in enumerate(zip(getattr(ja, kind), getattr(ta, kind))):
            np.testing.assert_array_equal(
                t.numpy().astype(np.int64), np.asarray(j).astype(np.int64),
                err_msg=f"{kind}[{i}]")


@pytest.mark.parametrize("case", ["clean", "load_value", "unsorted"])
def test_mock_failures_equal_jax(witnesses, case):
    jm, tm = witnesses
    ja = _tamper(jm, jm.witness(_trace(jtinyram)), JFP, case)
    ta = _tamper(tm, tm.witness(_trace(ttinyram), device="cpu"), FP, case)
    want = jplonk.MockProver(jm.cs, ja).verify()
    got = tplonk.MockProver(tm.cs, ta).verify()
    assert [(f.kind, f.name, f.detail) for f in got] == \
        [(f.kind, f.name, f.detail) for f in want]
    assert bool(got) == (case != "clean")
