"""BASELINE config 3 at its published 32-bit word (W = 32, 8 registers,
k = 18; `benchmark/configs/config3w32.json`) held against the benchmark's
plain reference (`benchmark/reference/`, Python integers and NumPy), at
small sizes on the CPU:

  * the port's native emulator equals the reference emulator, field by
    field as the benchmark's check compares them, on seeded programs of
    the configuration's class and on programs at the word's edges (2^32-1,
    2^31 as the signed -2^31, shifts of 31 and beyond the word, the divisor
    2^16-1, division by 0);
  * on short W = 32 traces at k = 18, the port's `exe_witness` satisfies
    every gate of the reference's constraint system on the rows the trace
    and the memory table use, each evaluated with exact integers mod p,
    and every lookup input on those rows is a row of its table;
  * the native emulator refuses words above 32 bits, where its products
    would overflow 64 bits;
  * the committed reference constants are those of (32, 8, 18) and the
    program class is config 3's.

Nothing here imports the JAX package; `tests/test_torch_w32_jax.py` holds
the same emulator and witness against it.  The proof at this size runs on
the card: `tests/test_torch_w32_cuda.py`.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness, programs
from benchmark.reference import constants, emulator, isa
from benchmark.reference.expr import evaluate
from benchmark.reference.field import P
from benchmark.reference.tinyram_cs import TinyRamCS as RefCS
from benchmark.reference.tinyram_cs import fixed_columns, instance_columns
from benchmark.spec import HERE
from tinyram_tpu_torch.tinyram.exe import TinyRamCS, exe_witness
from tinyram_tpu_torch.tinyram.exe import instance_columns as port_instance_columns
from tinyram_tpu_torch.tinyram.isa import Imm, Instruction, Reg
from tinyram_tpu_torch.tinyram.native import eval_program_native

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

CONFIGS = os.path.join(HERE, "configs")
TOP = (1 << 32) - 1
SIGN = 1 << 31  # -2^31 as a signed word


def _config(name: str) -> dict:
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)


CONFIG = _config("config3w32")
W, R, K = CONFIG["word_bits"], CONFIG["reg_count"], CONFIG["k"]


def _port(prog):
    return [Instruction(op, ri, rj, Imm(v) if kind == "imm" else Reg(v))
            for op, ri, rj, (kind, v) in prog]


def _ref(prog):
    return [isa.Instruction(op, ri, rj, isa.Imm(v) if kind == "imm"
                            else isa.Reg(v)) for op, ri, rj, (kind, v) in prog]


def _imm(op, ri, rj, v):
    return (op, ri, rj, ("imm", v))


def _reg(op, ri, rj, r):
    return (op, ri, rj, ("reg", r))


# programs at the word's edges, each ending in Answer
EDGES = {
    "products_of_the_top_word": [
        _imm("Mov", 1, None, TOP), _reg("Mull", 2, 1, 1),
        _reg("UMulh", 3, 1, 1), _reg("SMulh", 4, 1, 1),
        _imm("Mull", 5, 1, 2), _imm("UMulh", 6, 1, SIGN),
        _reg("Answer", None, None, 3)],
    "signed_extremes": [
        _imm("Mov", 1, None, SIGN), _imm("Mov", 2, None, TOP),
        _reg("SMulh", 3, 1, 1), _reg("SMulh", 4, 1, 2),
        _imm("SMulh", 5, 2, SIGN), _imm("SMulh", 6, 1, SIGN - 1),
        _reg("Cmpg", 1, None, 2), _reg("Cmpge", 2, None, 1),
        _imm("Cmpg", 2, None, SIGN), _reg("CMov", 7, None, 4),
        _reg("Answer", None, None, 3)],
    "shifts_of_31_and_beyond": [
        _imm("Mov", 1, None, TOP), _imm("Shl", 2, 1, 31),
        _imm("Shr", 3, 1, 31), _imm("Shl", 4, 1, 32), _imm("Shr", 5, 1, 33),
        _imm("Shr", 6, 1, TOP), _imm("Mov", 7, None, SIGN),
        _imm("Shl", 7, 7, 1), _reg("Answer", None, None, 3)],
    "divisions": [
        _imm("Mov", 1, None, TOP), _imm("UDiv", 2, 1, (1 << 16) - 1),
        _imm("UMod", 3, 1, (1 << 16) - 1), _imm("UDiv", 4, 1, 0),
        _imm("UMod", 5, 1, 0), _imm("Mov", 6, None, SIGN),
        _reg("UMod", 7, 1, 6), _reg("Answer", None, None, 3)],
    "carries_borrows_and_compares": [
        _imm("Mov", 1, None, TOP), _imm("Add", 2, 1, 1),
        _imm("Sub", 3, 0, 1), _imm("Not", 4, None, 0),
        _reg("Cmpa", 1, None, 4), _imm("Cmpae", 0, None, 1),
        _imm("Cmpe", 4, None, TOP), _imm("Xor", 5, 1, SIGN),
        _imm("And", 6, 1, SIGN), _imm("Or", 7, 0, SIGN),
        _reg("Answer", None, None, 2)],
    "memory_at_high_addresses": [
        _imm("Mov", 1, None, TOP), _imm("StoreW", 1, None, TOP - 3),
        _imm("LoadW", 2, None, TOP - 3), _imm("StoreW", 2, None, SIGN),
        _imm("LoadW", 3, None, SIGN), _imm("LoadW", 4, None, 8),
        _reg("Answer", None, None, 3)],
}

# (steps_log2, seed) of the seeded programs of the configuration's class
DRAWS = [(8, 0), (9, 1), (10, 2), (8, 2**31 + 7), (9, 2**33 + 5),
         (10, 3190000101)]


def _class_program(steps_log2: int, seed: int) -> list:
    return programs.program(CONFIG, steps_log2,
                            programs.stream(seed, "test_torch_w32"))


def _same_traces(prog):
    port = eval_program_native(_port(prog), W, R)
    ref = emulator.eval_program(_ref(prog), W, R)
    assert harness.compare_traces(port, ref) == []
    return port, ref


@pytest.mark.parametrize("steps_log2,seed", DRAWS)
def test_native_emulator_equals_the_reference_on_the_class(steps_log2, seed):
    prog = _class_program(steps_log2, seed)
    assert all(0 <= v <= TOP for _, _, _, (kind, v) in prog if kind == "imm")
    port, _ = _same_traces(prog)
    assert len(port.pc) > (1 << steps_log2) - 20
    assert int(port.regs.max()) < 1 << W


@pytest.mark.parametrize("name", sorted(EDGES))
def test_native_emulator_equals_the_reference_at_the_edges(name):
    port, _ = _same_traces(EDGES[name])
    assert int(port.regs.min()) >= 0 and int(port.regs.max()) <= TOP


def test_the_edges_reach_the_top_of_the_word():
    """What the edge programs compute, by hand: the high products of the
    top word, the signed high products of -2^31 and -1."""
    regs = {name: eval_program_native(_port(prog), W, R).regs[-1]
            for name, prog in EDGES.items()}
    top = regs["products_of_the_top_word"]
    assert int(top[2]) == (TOP * TOP) & TOP
    assert int(top[3]) == (TOP * TOP) >> 32 == TOP - 1
    assert int(top[4]) == 0  # (-1)·(-1) = 1: high word 0
    signed = regs["signed_extremes"]
    assert int(signed[3]) == 1 << 30  # (-2^31)^2 = 2^62
    assert int(signed[4]) == 0  # (-2^31)·(-1) = 2^31: high word 0
    shifts = regs["shifts_of_31_and_beyond"]
    assert [int(v) for v in shifts[2:7]] == [SIGN, 1, 0, 0, 0]


@pytest.mark.parametrize("word_bits", [33, 40, 64])
def test_native_emulator_refuses_words_above_32_bits(word_bits):
    prog = [Instruction("Answer", None, None, Imm(0))]
    with pytest.raises(ValueError, match="word_bits"):
        eval_program_native(prog, word_bits, R)


# ------------------------------------------------------------- the witness

class _Rows:
    """Columns at some rows as exact integers mod p (rotations read mod
    n), and expressions over them, for the gates."""

    def __init__(self, cols: dict, rows: np.ndarray, n: int):
        self.cols, self.rows, self.n = cols, rows, n
        self.cache: dict = {}

    def var(self, kind, index, rotation):
        key = (kind, index, rotation)
        if key not in self.cache:
            vals = self.cols[(kind, index)][(self.rows + rotation) % self.n]
            self.cache[key] = np.array([int(v) % P for v in vals],
                                       dtype=object)
        return self.cache[key]

    def eval(self, expr):
        return evaluate(
            expr, var=self.var,
            const=lambda v: np.full(len(self.rows), v % P, dtype=object),
            add=lambda a, b: (a + b) % P, mul=lambda a, b: a * b % P,
            neg=lambda a: (-a) % P)


class _Int64:
    """Expressions over rows of the columns in int64, for the lookups: a
    bound on every intermediate value (the columns' largest magnitudes
    carried through the expression) below 2^62 shows the result exact, and
    equal int64 values are then equal mod p."""

    def __init__(self, cols: dict, rows: np.ndarray, n: int):
        self.cols, self.rows, self.n = cols, rows, n
        self.cache: dict = {}

    def column(self, kind, index, rotation):
        key = (kind, index, rotation)
        if key not in self.cache:
            self.cache[key] = np.asarray(self.cols[(kind, index)],
                                         dtype=np.int64)[
                (self.rows + rotation) % self.n]
        return self.cache[key]

    def eval(self, expr) -> np.ndarray:
        top = evaluate(
            expr, var=lambda *v: int(np.abs(self.column(*v)).max()),
            const=abs, add=lambda a, b: a + b, mul=lambda a, b: a * b,
            neg=lambda a: a)
        assert top < 1 << 62
        out = evaluate(expr, var=self.column, const=np.int64, add=np.add,
                       mul=np.multiply, neg=np.negative)
        return np.broadcast_to(out, self.rows.shape)

    def tuples(self, exprs) -> np.ndarray:
        """One opaque value a row, equal where the rows' tuples of `exprs`
        are equal (each row's int64 entries as one void scalar)."""
        vals = np.ascontiguousarray(np.stack([self.eval(e) for e in exprs],
                                             axis=1))
        return vals.view(np.dtype((np.void, 8 * len(exprs))))[:, 0]


# one short trace: a loop of the configuration's class, then every edge
# program's lines, then Answer
WITNESS_PROGRAM = _class_program(8, 3190000102)[:-1] + [
    line for name in sorted(EDGES) for line in EDGES[name][:-1]] + [
    _reg("Answer", None, None, 3)]


@pytest.fixture(scope="module")
def witness():
    """(reference constraint system, trace, every column by (kind, index)):
    the reference's fixed and instance columns, the port's advice
    (`exe_witness`), of WITNESS_PROGRAM at (32, 8, 18)."""
    ref = RefCS(W, R, k=K)
    trace = eval_program_native(_port(WITNESS_PROGRAM), W, R)
    advice = exe_witness(TinyRamCS(W, R, k=K), trace)
    assert set(advice) == set(ref.col.advice)
    cols = {}
    for by_name, values in (
            (ref.col.fixed, fixed_columns(ref)), (ref.col.advice, advice),
            (ref.col.instance,
             instance_columns(ref, _ref(WITNESS_PROGRAM), trace.answer))):
        for name, col in by_name.items():
            cols[(col.kind, col.index)] = np.asarray(values[name])
    return ref, trace, cols


def _used_rows(trace) -> np.ndarray:
    return np.arange(max(len(trace.pc), len(trace.accesses)) + 2)


def _failing_gates(ref, trace, cols) -> list[str]:
    """The gate polynomials not zero on every used row."""
    rows = _Rows(cols, _used_rows(trace), ref.n)
    return [f"{gate.name}[{i}]" for gate in ref.cs.gates
            for i, poly in enumerate(gate.polys)
            if np.any(rows.eval(poly) != 0)]


def _failing_lookups(ref, trace, cols) -> list[str]:
    """The lookups with an input tuple on a used row that is no tuple of
    its table on the usable rows, and the LogUp inputs with a value that
    is not in its table."""
    cs, n = ref.cs, ref.n
    inputs = _Int64(cols, _used_rows(trace), n)
    tables = _Int64(cols, np.arange(cs.usable_rows(n)), n)
    bad = [lk.name for lk in cs.lookups
           if not np.isin(inputs.tuples(lk.inputs),
                          tables.tuples(lk.tables)).all()]
    for rl in cs.range_lookups:
        table = tables.eval(rl.table)
        bad += [f"{rl.name}[{j}]" for j, e in enumerate(rl.inputs)
                if not np.isin(inputs.eval(e), table).all()]
    return bad


def test_w32_witness_satisfies_the_reference_gates(witness):
    ref, trace, cols = witness
    ran = {WITNESS_PROGRAM[pc][0] for pc in trace.pc}
    assert {"Mull", "UMulh", "SMulh", "Shl", "Shr", "UDiv", "UMod",
            "StoreW", "LoadW", "Cmpg", "Cmpge"} <= ran
    assert _failing_gates(ref, trace, cols) == []


def test_w32_lookup_inputs_are_rows_of_their_tables(witness):
    assert _failing_lookups(*witness) == []


def test_the_port_instance_columns_equal_the_reference(witness):
    """The port's program table (its 2^16 rows padded with the Answer
    line) equals the reference's, row by row."""
    ref, trace, cols = witness
    port = port_instance_columns(TinyRamCS(W, R, k=K), _port(WITNESS_PROGRAM),
                                 trace.answer)
    assert set(port) == set(ref.col.instance)
    for name, col in ref.col.instance.items():
        assert np.array_equal(port[name], cols[(col.kind, col.index)]), name


def _altered(ref, cols, name: str, row: int) -> dict:
    """The columns with advice column `name` off by one bit at `row`."""
    col = ref.col.advice[name]
    out = dict(cols)
    out[(col.kind, col.index)] = cols[(col.kind, col.index)].copy()
    out[(col.kind, col.index)][row] ^= 1
    return out


def test_the_checks_catch_a_wrong_high_product_and_a_wrong_load(witness):
    """Neither check is vacuous: a high product off by one fails a gate, a
    loaded value off by one a lookup."""
    ref, trace, cols = witness
    ops = [WITNESS_PROGRAM[pc] for pc in trace.pc]
    step = [i for i, op in enumerate(ops) if op[0] == "UMulh"][0]
    wrong = _altered(ref, cols, f"reg{ops[step][1]}", step + 1)
    assert _failing_gates(ref, trace, wrong)
    load = [i for i, op in enumerate(ops) if op[0] == "LoadW"][0]
    wrong = _altered(ref, cols, "value", load)
    assert "exe_mem" in _failing_lookups(ref, trace, wrong)


# ------------------------------------------------------------- the files

def test_the_constants_are_those_of_w32():
    path = constants.path_for(os.path.join(CONFIGS, "config3w32.json"))
    with open(path) as f:
        data = json.load(f)
    assert (data["word_bits"], data["reg_count"], data["k"]) == (W, R, K)
    with pytest.raises(ValueError, match=r"\(32, 8, 18\)"):
        constants.load(path, 24, 8, 17, g=None)
    const = constants.Constants(data)
    ref = RefCS(W, R, k=K)
    assert const.table_len == ref.table_len == 1 << 16
    assert len(const.fixed) == ref.cs.num_fixed
    assert len(const.lagrange) == constants.LINES
    config3 = _config("config3")
    assert const.srs_sha256 != constants.Constants(json.load(open(
        constants.path_for(os.path.join(CONFIGS, "config3.json"))))).srs_sha256
    assert CONFIG["program"] == config3["program"]
    assert CONFIG["guarantee"] == config3["guarantee"]
    assert CONFIG["reduced"] == [] and CONFIG["steps_log2"] == 16
