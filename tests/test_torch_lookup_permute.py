"""The prover's lookup sort-and-match on the device (`plonk/lookup_rank.py`)
against the JAX package's host rules it replaced: the plookup permutation
against `tinyram_tpu.plonk.prover.permute_lookup` (Python ints,
`Counter.elements()` order of the leftovers) and `permute_lookup_np`
(int64, every value below 2^62: ascending leftovers), element for element,
and the LogUp counts against the JAX prover's rule (int64 below 2^62,
Python ints above); each missing-value error with the host's message.
Inputs are drawn from seeds: heavy duplicates in A, repeated table values,
table values absent from A, values on both sides of 2^62 and near p.  The
range toy circuit's proof, its LogUp counted on the device, gives the
recorded JAX proof and error.  Run here on the CPU;
`tests/test_torch_lookup_cuda.py` holds the card to this CPU version.
"""

import os
import random

import numpy as np
import pytest
import torch

from tinyram_tpu.plonk.prover import permute_lookup, permute_lookup_np
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.field.params import ints_to_limb_array
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.plonk import lookup_rank, toy
from tinyram_tpu_torch.plonk.lookup_rank import logup_counts, plookup_sources
from tinyram_tpu_torch.shard.paths import SeededRng
from tinyram_tpu_torch.utils.profiling import counters

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

P = FP.modulus
BIG = 1 << 62
TOYS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_golden_toys.npz")


def _values(rng: random.Random, kind: str, count: int) -> list[int]:
    """`count` distinct field values of a kind."""
    lo, hi = {"small": (0, 1 << 20), "i64": (0, BIG - 1),
              "below": (BIG - 100, BIG - 1), "edge": (BIG - 40, BIG + 40),
              "wide": (0, P - 1), "near_p": (P - 200, P - 1)}[kind]
    return rng.sample(range(lo, hi + 1), count) if hi - lo < 1 << 40 else \
        [rng.randint(lo, hi) for _ in range(count)]


def _lookup(seed: int, kind: str, u: int, distinct: int, a_share: float):
    """(A, S), u values each: S holds `distinct` values (repeated), A draws
    from a share `a_share` of them, with heavy duplicates."""
    rng = random.Random(seed)
    vals = _values(rng, kind, distinct)
    s = vals + [rng.choice(vals) for _ in range(u - distinct)]
    rng.shuffle(s)
    used = vals[: max(1, int(distinct * a_share))]
    weights = [rng.random() ** 4 for _ in used]  # a few values dominate A
    a = rng.choices(used, weights=weights, k=u)
    return a, s


# (kind, u, distinct table values, share of them A uses)
CASES = {
    "small_heavy_duplicates": ("small", 256, 40, 0.5),
    "small_repeated_table": ("small", 300, 7, 1.0),
    "i64_absent_from_a": ("i64", 200, 150, 0.2),
    "just_below_2_62": ("below", 160, 60, 0.7),
    "edge_of_2_62": ("edge", 160, 60, 0.7),
    "wide_field": ("wide", 256, 100, 0.6),
    "near_p": ("near_p", 128, 90, 0.9),
    "one_value": ("wide", 64, 1, 1.0),
}


def _plain(cols: list[list[int]]) -> torch.Tensor:
    """(16, C, u) plain limbs of C columns of u values."""
    return torch.stack([torch.as_tensor(ints_to_limb_array(c)) for c in cols],
                       dim=1)


def _host(a: list[int], s: list[int]):
    """The host's (A', S') under the rule the prover chose for them."""
    if max(a + s) < BIG:
        ap, sp = permute_lookup_np(np.array(a, dtype=np.int64),
                                   np.array(s, dtype=np.int64))
        return [int(v) for v in ap], [int(v) for v in sp]
    return permute_lookup(a, s)


def _device(pairs: list[tuple[list[int], list[int]]]):
    """(A', S') of each lookup through `plookup_sources`' indices."""
    src = plookup_sources(_plain([c for pair in pairs for c in pair]))
    out = []
    for li, (a, s) in enumerate(pairs):
        both = a + s
        out.append(([both[i] for i in src[li, 0].tolist()],
                    [both[i] for i in src[li, 1].tolist()]))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plookup_permutation_equals_the_host_rule(case):
    a, s = _lookup(sum(map(ord, case)), *CASES[case])
    assert _device([(a, s)]) == [_host(a, s)]


@pytest.mark.parametrize("per", [None, 1, 2])
def test_lookups_ranked_in_groups_equal_each_alone(per, monkeypatch):
    """Five lookups of both rules in one call, ranked all together or in
    groups of `per` lookups (RANK_ELEMENTS cut to fit)."""
    u = 128
    pairs = [_lookup(10 + i, CASES[c][0], u, *CASES[c][2:])
             for i, c in enumerate(["wide_field", "small_heavy_duplicates",
                                    "edge_of_2_62", "near_p",
                                    "just_below_2_62"])]
    if per is not None:
        monkeypatch.setattr(lookup_rank, "RANK_ELEMENTS", 2 * u * per)
    assert _device(pairs) == [_host(a, s) for a, s in pairs]


@pytest.mark.parametrize("case", ["small_heavy_duplicates", "near_p"])
def test_missing_plookup_input_raises_the_host_message(case, monkeypatch):
    """The least missing value of the first lookup that has one, the
    lookups ranked in groups of one: the error is in the second group."""
    a, s = _lookup(7, *CASES[case])
    gone = sorted(set(a))[1:3]
    keep = next(v for v in s if v not in gone)
    bad = [keep if v in gone else v for v in s]
    with pytest.raises(ValueError) as want:
        _host(a, bad)
    monkeypatch.setattr(lookup_rank, "RANK_ELEMENTS", 2 * len(a))
    with pytest.raises(ValueError) as got:
        _device([(a, s), (a, bad), (bad, s)])
    assert str(got.value) == str(want.value)
    assert str(min(gone)) in str(got.value)


def _logup(seed: int, kind: str, u: int, nin: int):
    """A table of u values (some repeated) and nin input columns drawn
    from it."""
    rng = random.Random(seed)
    vals = _values(rng, kind, u // 2)
    table = vals + [rng.choice(vals) for _ in range(u - len(vals))]
    rng.shuffle(table)
    ins = [[rng.choice(vals[: u // 4]) for _ in range(u)] for _ in range(nin)]
    return table, ins


def _logup_host(table: list[int], ins: list[list[int]], name: str):
    """The JAX prover's LogUp counts (its inline rule in `_prove`): as int64
    where every value is below 2^62, else as Python ints."""
    dt = np.int64 if max(table + sum(ins, [])) < BIG else object
    t = np.array(table, dtype=dt)
    x = np.concatenate([np.array(c, dtype=dt) for c in ins])
    u = len(t)
    order = np.argsort(t, kind="stable")
    sorted_t = t[order]
    idx = np.searchsorted(sorted_t, x, side="left")
    ok = (idx < u) & (sorted_t[np.minimum(idx, u - 1)] == x)
    if not ok.all():
        raise ValueError(f"range_lookup {name}: input {x[~ok][0]} not in table")
    counts = np.zeros(u, dtype=np.int64)
    counts[order] = np.bincount(idx, minlength=u)[:u]
    return counts


def _device_counts(table: list[int], ins: list[list[int]], name: str):
    """`logup_counts` as Python ints."""
    got = logup_counts(_plain(ins), _plain([table])[:, 0], name)
    assert int(got[4:].abs().sum()) == 0
    return [sum(int(got[i, r]) << (16 * i) for i in range(4))
            for r in range(got.shape[1])]


LOGUP_CASES = {"small": ("small", 256, 5), "i64": ("i64", 200, 3),
               "just_below_2_62": ("below", 100, 2),
               "edge_of_2_62": ("edge", 100, 3), "wide_field": ("wide", 128, 4),
               "near_p": ("near_p", 160, 3)}


@pytest.mark.parametrize("case", list(LOGUP_CASES))
def test_logup_counts_equal_numpy(case):
    kind, u, nin = LOGUP_CASES[case]
    table, ins = _logup(len(case), kind, u, nin)
    counts = _logup_host(table, ins, "rng")
    assert _device_counts(table, ins, "rng") == counts.tolist()
    assert counts.sum() == u * nin and counts.any()


@pytest.mark.parametrize("per", [1, 2])
def test_logup_inputs_ranked_in_groups_equal_all_at_once(per, monkeypatch):
    """Five input columns ranked beside the table `per` at a time
    (RANK_ELEMENTS cut to fit), values on both sides of 2^62."""
    table, ins = _logup(21, "edge", 64, 5)
    monkeypatch.setattr(lookup_rank, "RANK_ELEMENTS", 64 * (per + 1))
    assert _device_counts(table, ins, "rng") == \
        _logup_host(table, ins, "rng").tolist()


@pytest.mark.parametrize("kind,per", [
    pytest.param("small", None, id="small"),
    pytest.param("wide", None, id="wide"),
    pytest.param("wide", 1, id="wide_in_groups")])
def test_missing_logup_input_raises_the_host_message(kind, per, monkeypatch):
    """The first missing input column by column, here in the third column:
    with `per` 1 in the third group of columns ranked."""
    table, ins = _logup(11, kind, 64, 3)
    ins[2][7] = max(table) + 1
    ins[2][9] = max(table) + 2
    with pytest.raises(ValueError) as want:
        _logup_host(table, ins, "rng")
    if per is not None:
        monkeypatch.setattr(lookup_rank, "RANK_ELEMENTS", 64 * (per + 1))
    with pytest.raises(ValueError) as got:
        logup_counts(_plain(ins), _plain([table])[:, 0], "rng")
    assert str(got.value) == str(want.value)
    assert str(max(table) + 1) in str(want.value)


@pytest.mark.parametrize("test", ["range_roundtrip", "range_out_of_range"])
def test_range_toy_logup_on_the_device_gives_the_jax_proof(test):
    """`create_proof` of the range toy circuit, its LogUp argument counted
    by `logup_counts`: the recorded JAX bytes, or the JAX prover's error,
    and the counter names the device."""
    golden = np.load(TOYS)
    circuit, seed = toy.TOY_TESTS[test]
    srs = setup(toy.TOY_CIRCUITS[circuit][1], device="cpu")
    t, pk = toy.toy_keys(circuit, srs, "cpu")
    before = counters.snapshot("lookup.multiplicity.")
    got = toy.prove_toy(test, srs, pk, t, SeededRng(seed), "cpu")
    if test == "range_out_of_range":
        assert got["error"] == str(golden[f"{test}/error"])
        return
    assert got["proof"] == golden[f"{test}/proof"].tobytes()
    after = counters.snapshot("lookup.multiplicity.")
    ran = {k: v[0] - before.get(k, (0, 0))[0] for k, v in after.items()}
    assert ran == {"lookup.multiplicity.card": 1}


@pytest.mark.parametrize("kind", ["wide", "near_p", "small"])
def test_from_mont_gives_the_canonical_limbs_the_ranking_reads(kind):
    """The ranking orders `FP.from_mont`'s limbs as integers: each below
    2^16 and the value below p, equal to the value encoded."""
    vals = _values(random.Random(5), kind, 64) + [0, P - 1]
    plain = FP.from_mont(FP.encode(vals))
    assert int(plain.min()) >= 0 and int(plain.max()) < 1 << 16
    assert torch.equal(plain, torch.as_tensor(ints_to_limb_array(vals)))
