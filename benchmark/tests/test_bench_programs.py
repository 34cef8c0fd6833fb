"""The traffic generator: seeded programs of the configurations' classes."""

import json
import os

import pytest

from benchmark import programs
from benchmark.reference import emulator, isa
from benchmark.reference.tinyram_cs import TinyRamCS
from benchmark.spec import HERE

SEEDS = (0, 1, 2**31 + 7, 2**33 + 5)


def _config(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def _ref(prog):
    return [isa.Instruction(op, ri, rj, isa.Imm(v) if kind == "imm"
                            else isa.Reg(v)) for op, ri, rj, (kind, v) in prog]


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_same_seed_same_programs(name):
    cfg = _config(name)
    traffic = {"steps_log2": [cfg["steps_log2"]]}
    for seed in SEEDS:
        a, b = programs.Client(cfg, traffic, seed), programs.Client(cfg, traffic, seed)
        assert [a.program(i) for i in range(3)] == [b.program(i) for i in range(3)]
        assert a.blinding_seed(2) == b.blinding_seed(2)
        assert a.warmup_programs() == b.warmup_programs()
    one = programs.Client(cfg, traffic, SEEDS[0]).program(0)
    other = programs.Client(cfg, traffic, SEEDS[1]).program(0)
    assert one != other
    assert [p[:3] for p in one] == [p[:3] for p in other]


@pytest.mark.parametrize("name,steps,accesses", [("config2", 4087, 0),
                                                 ("config3", 65533, 13798)])
def test_programs_fit_their_circuit(name, steps, accesses):
    cfg = _config(name)
    w, k = cfg["word_bits"], cfg["k"]
    tcs = TinyRamCS(w, cfg["reg_count"], k=k)
    client = programs.Client(cfg, {}, 2**31 + 99)
    for i in range(2):
        prog = client.program(i)
        assert len(prog) <= tcs.table_len == 4096
        assert all(0 <= v < 1 << w for _, _, _, (kind, v) in prog if kind == "imm")
        tr = emulator.eval_program(_ref(prog), w, cfg["reg_count"])
        assert len(tr) == steps
        assert sum(a.kind != "init" for a in tr.accesses) == accesses - (2 if accesses else 0)
        assert len(tr.accesses) == accesses
        assert len(tr) <= tcs.st_rows - 1 and len(tr.accesses) <= tcs.st_rows - 1


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_programs_are_the_baseline_loops(name):
    """The copy keeps the port's program shape: the same instructions, with
    the immediates drawn, and the same number of steps."""
    from tinyram_tpu_torch.tinyram import bench_programs

    cfg = _config(name)
    original = getattr(bench_programs, f"{name}_program")(
        1 << cfg["steps_log2"], word_bits=cfg["word_bits"])
    prog = programs.Client(cfg, {}, 5).program(0)
    assert [(i.op, i.ri, i.rj) for i in original] == [p[:3] for p in prog]
    assert [type(i.a).__name__ == "Reg" for i in original] == \
        [kind == "reg" for _, _, _, (kind, _) in prog]


def test_draws_stay_in_their_ranges():
    cfg = _config("config3")
    for seed in range(40):
        prog = programs.Client(cfg, {}, seed).program(0)
        by_op = {}
        for op, _, _, (kind, v) in prog:
            by_op.setdefault(op, []).append((kind, v))
        assert all(1 <= v < 24 for kind, v in by_op["Shl"] + by_op["Shr"])
        assert all(1 <= v < 1 << 12 for kind, v in by_op["UMod"])
        stores = [v for _, v in by_op["StoreW"]]
        assert len(set(stores)) == 2 and all(v < 1 << 23 for v in stores)
        assert sorted(v for _, v in by_op["LoadW"]) == sorted(stores)


def test_a_list_of_sizes_is_sent_whole_by_every_seed():
    cfg = _config("config3")
    traffic = {"steps_log2": [12, 13, 14]}
    orders = [programs.Client(cfg, traffic, seed).sizes for seed in SEEDS]
    assert all(sorted(o) == [12, 13, 14] for o in orders)
    assert len({tuple(o) for o in orders}) > 1
    client = programs.Client(cfg, traffic, 3)
    assert [len(p) for p in client.warmup_programs()] == [21, 21, 21]
    assert [client.steps_log2(i) for i in range(6)] == client.sizes * 2
