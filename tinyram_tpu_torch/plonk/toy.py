"""The toy circuits of the JAX package's tests and sharded dry run.

`ToyCircuit` is the circuit and witness of `__graft_entry__.dryrun_multichip`
and `tests/test_shard_prover.py` (`build_cs`, `_witness`): y = x² under a
fixed selector, y bound to the public input, a fixed-table range lookup of
x into [0, 16) and one copy constraint (x repeats on the first two rows):
one of every argument family, small enough to prove on a CPU.

`plonk_toy`, `range_toy` and `mixed_toy` are the circuits of
`tests/test_plonk.py` and `tests/test_range_lookup.py`, and `prove_toy`
runs the proof of each of their seven proof tests (`TOY_TESTS`) with the
port, returning the outcomes those tests assert.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field.field import FP
from ..utils.device import CUDA
from .circuit import Assignment, Column, ConstraintSystem
from .keygen import keygen
from .mock import MockProver
from .prover import create_proof
from .verifier import verify_proof

K = 6
N = 1 << K
P = FP.modulus


@dataclass
class ToyCircuit:
    cs: ConstraintSystem
    q: Column
    t_rng: Column
    x: Column
    y: Column
    pub: Column

    @property
    def usable(self) -> int:
        return self.cs.usable_rows(N)

    def fixed_assignment(self, device=CUDA, host: bool = False) -> Assignment:
        """The fixed columns alone: what `keygen` takes (`host`: see
        `Assignment`)."""
        asg = Assignment(self.cs, N, device, host=host)
        u = self.usable
        asg.set(self.q, [1] * u + [0] * (N - u))
        asg.set(self.t_rng, list(range(16)) + [0] * (N - 16))
        return asg

    def witness_values(self) -> list[int]:
        """x on the usable rows: 3, 3 (the copy), then (7 i) mod 16."""
        return [3, 3] + [(i * 7) % 16 for i in range(2, self.usable)]

    def public_values(self, xs: list[int]) -> list[int]:
        return [v * v % P for v in xs] + [0] * (N - len(xs))

    def assignment(self, device=CUDA, host: bool = False) -> Assignment:
        """The full assignment: x = `witness_values()`, y = x², and y in
        the public column."""
        xs = self.witness_values()
        asg = self.fixed_assignment(device, host)
        ys = self.public_values(xs)
        asg.set(self.x, xs + [0] * (N - len(xs)))
        asg.set(self.y, ys)
        asg.set(self.pub, ys)
        return asg


def toy_circuit() -> ToyCircuit:
    cs = ConstraintSystem()
    q = cs.fixed_column("q")
    t_rng = cs.fixed_column("t_rng")
    x = cs.advice_column("x")
    y = cs.advice_column("y")
    pub = cs.instance_column("pub")
    cs.blinding_factors = 4
    qe, xe, ye = q.cur(), x.cur(), y.cur()
    cs.gate("square", qe * (xe * xe - ye))
    cs.gate("bind_pub", qe * (ye - pub.cur()))
    cs.lookup("rng", [qe * xe], [t_rng.cur()])
    cs.copy(x, 0, x, 1)
    return ToyCircuit(cs, q, t_rng, x, y, pub)


# --- the toy circuits of tests/test_plonk.py and tests/test_range_lookup.py
# (copied: those files import JAX)

PLONK_K = 3  # test_plonk.py's K
PLONK_N = 1 << PLONK_K
RANGE_K = 6  # test_range_lookup.py's K
RANGE_N = 1 << RANGE_K


@dataclass
class PlonkToy:
    """`tests/test_plonk.py` `build_cs`: a mul gate, a public-input gate, a
    fixed-table and a dynamic-table lookup and one copy, K = 3."""

    cs: ConstraintSystem
    cols: tuple  # (q_mul, q_pub, q_rng, t_rng, a, b, c, d_tbl, s_tbl, q_dyn, inst)

    def assignment(self, pub_val: int = 7, tamper: str | None = None,
                   device=CUDA) -> tuple[Assignment, list[int]]:
        """`build_assignment`: the witness and the instance values; `tamper`
        ("mul", "copy", "rng", "dyn") breaks one argument."""
        (q_mul, q_pub, q_rng, t_rng, a, b, c, d_tbl, s_tbl, q_dyn,
         inst) = self.cols
        asg = Assignment(self.cs, PLONK_N, device)
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
        asg.set(t_rng, [7, 3, 42, 5, 0, 0, 0, 0])
        if tamper == "rng":
            asg.set(t_rng, [7, 3, 42, 4, 0, 0, 0, 0])
        asg.set(a, a_v)
        asg.set(b, b_v)
        asg.set(c, c_v)
        asg.set(d_tbl, [6, 4, 1, 2, 9, 0, 0, 0])
        asg.set(s_tbl, [1, 1, 1, 1, 1, 0, 0, 0])
        asg.set(q_dyn, [1, 1, 1, 1, 1, 1, 0, 0])
        if tamper == "dyn":
            asg.set(d_tbl, [6, 4, 1, 2, 8, 0, 0, 0])
        inst_v = [pub_val, 0, 0, 0, 0, 0, 0, 0]
        asg.set(inst, inst_v)
        return asg, inst_v


def plonk_toy() -> PlonkToy:
    cs = ConstraintSystem()
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
    return PlonkToy(cs, (q_mul, q_pub, q_rng, t_rng, a, b, c, d_tbl, s_tbl,
                         q_dyn, inst))


@dataclass
class RangeToy:
    """`tests/test_range_lookup.py` `_build`: n_inputs advice columns, each
    range-checked by one LogUp argument against t_rng (0..15), K = 6."""

    cs: ConstraintSystem
    t_rng: Column
    cols: list

    def assignment(self, vals_fn, device=CUDA) -> Assignment:
        """`_assign`: column ci holds vals_fn(ci, r) on the usable rows."""
        u = self.cs.usable_rows(RANGE_N)
        asg = Assignment(self.cs, RANGE_N, device)
        asg.set(self.t_rng, [i % 16 for i in range(RANGE_N)])
        for ci, c in enumerate(self.cols):
            asg.set(c, [vals_fn(ci, r) for r in range(u)] + [0] * (RANGE_N - u))
        return asg


def range_toy(n_inputs: int = 5) -> RangeToy:
    cs = ConstraintSystem()
    t_rng = cs.fixed_column("t_rng")
    cols = [cs.advice_column(f"x{i}") for i in range(n_inputs)]
    cs.blinding_factors = 4
    cs.range_lookup("rng", [c.cur() for c in cols], t_rng.cur())
    return RangeToy(cs, t_rng, cols)


@dataclass
class MixedToy:
    """`test_range_lookup_mixed_with_plookup`'s circuit: a LogUp range
    lookup of x and y beside a tuple plookup of (q·x, q·y) in a table of
    squares mod 16, K = 6."""

    cs: ConstraintSystem
    cols: tuple  # (t_rng, t_sq_x, t_sq_y, q, x, y)

    @property
    def usable(self) -> int:
        return self.cs.usable_rows(RANGE_N)

    def witness_values(self, bad_row: int | None = None):
        """(xs, ys): x = i mod 8, y = x² mod 16; `bad_row` adds one to that
        row's y (in range, but not a pair of the table)."""
        xs = [i % 8 for i in range(self.usable)]
        ys = [(i % 8) ** 2 % 16 for i in range(self.usable)]
        if bad_row is not None:
            ys[bad_row] = (ys[bad_row] + 1) % 16
        return xs, ys

    def assignment(self, xs, ys, device=CUDA) -> Assignment:
        t_rng, t_sq_x, t_sq_y, q, x, y = self.cols
        n, u = RANGE_N, self.usable
        asg = Assignment(self.cs, n, device)
        asg.set(t_rng, [i % 16 for i in range(n)])
        asg.set(t_sq_x, [i % 8 for i in range(n)])
        asg.set(t_sq_y, [(i % 8) ** 2 % 16 for i in range(n)])
        asg.set(q, [1] * u + [0] * (n - u))
        asg.set(x, list(xs) + [0] * (n - len(xs)))
        asg.set(y, list(ys) + [0] * (n - len(ys)))
        return asg


def mixed_toy() -> MixedToy:
    cs = ConstraintSystem()
    t_rng = cs.fixed_column("t_rng")
    t_sq_x = cs.fixed_column("t_sq_x")
    t_sq_y = cs.fixed_column("t_sq_y")
    q = cs.fixed_column("q")
    x = cs.advice_column("x")
    y = cs.advice_column("y")
    cs.blinding_factors = 4
    cs.range_lookup("rng", [x.cur(), y.cur()], t_rng.cur())
    cs.lookup("sq", [q.cur() * x.cur(), q.cur() * y.cur()],
              [t_sq_x.cur(), t_sq_y.cur()])
    return MixedToy(cs, (t_rng, t_sq_x, t_sq_y, q, x, y))


# --- the seven proof tests of those files, as the port runs them

# circuit -> (builder, K)
TOY_CIRCUITS = {
    "plonk": (plonk_toy, PLONK_K),
    "range5": (range_toy, RANGE_K),
    "range2": (lambda: range_toy(n_inputs=2), RANGE_K),
    "mixed": (mixed_toy, RANGE_K),
}
# JAX test -> (circuit, seed of its prover's stream); the JAX tests:
# test_plonk.py test_real_proof_{roundtrip,soundness,rejects_bad_witness},
# test_range_lookup.py test_range_lookup_{prove_verify_roundtrip,
# prover_rejects_out_of_range,forged_multiplicity_rejected,
# mixed_with_plookup}
TOY_TESTS = {
    "plonk_roundtrip": ("plonk", 31),
    "plonk_soundness": ("plonk", 32),
    "plonk_bad_witness": ("plonk", 33),
    "range_roundtrip": ("range5", 34),
    "range_out_of_range": ("range5", 35),
    "range_forged_m": ("range2", 36),
    "mixed": ("mixed", 37),
}
FORGED_M_BYTE = 2 * 33 + 5  # in the m commitment, after two advice points


def toy_key_assignment(circuit: str, toy, device=CUDA) -> Assignment:
    """The assignment whose fixed columns `keygen` takes: the honest
    witness for "plonk" (as `proof_setup` does), zeros otherwise."""
    if circuit == "plonk":
        return toy.assignment(device=device)[0]
    if circuit == "mixed":
        zeros = [0] * toy.usable
        return toy.assignment(zeros, zeros, device)
    return toy.assignment(lambda ci, r: 0, device)


def toy_witness(test: str, toy, device=CUDA) -> tuple[Assignment, list]:
    """The assignment a test proves and the instance columns its verifier
    takes."""
    if test.startswith("plonk"):
        asg, inst_v = toy.assignment(
            tamper="mul" if test == "plonk_bad_witness" else None,
            device=device)
        return asg, [inst_v]
    if test == "mixed":
        return toy.assignment(*toy.witness_values(), device), []
    vals = {
        "range_roundtrip": lambda ci, r: (5 * ci + 2 * r) % 16,
        "range_out_of_range":
            lambda ci, r: 99 if (ci, r) == (0, 0) else r % 16,
        "range_forged_m": lambda ci, r: (ci + r) % 16,
    }[test]
    return toy.assignment(vals, device), []


def flipped(proof: bytes, at: int) -> bytes:
    """The proof with the low bit of byte `at` flipped."""
    bad = bytearray(proof)
    bad[at] ^= 1
    return bytes(bad)


def toy_outcomes(test: str, verify, instances: list, proof: bytes) -> dict:
    """The verdicts the JAX test asserts, as {check: bool}; `verify(
    instances, proof)` is the verifier under the test's key."""
    out = {"verify": verify(instances, proof)}
    if test == "plonk_soundness":
        bad_inst = list(instances[0])
        bad_inst[0] = 8
        out["wrong_public"] = verify([bad_inst], proof)
    if test in ("plonk_soundness", "range_roundtrip"):
        out["flipped_byte"] = verify(instances, flipped(proof, len(proof) // 2))
    if test == "range_forged_m":
        out["forged_m"] = verify(instances, flipped(proof, FORGED_M_BYTE))
    return out


def mixed_mock_outcomes(toy: MixedToy, device=CUDA) -> dict:
    """The mixed test's mock verdicts: the honest witness is clean, and a
    y in range but off the table's pairs is named by the "sq" lookup."""
    bad = toy.assignment(*toy.witness_values(bad_row=3), device)
    return {"mock_clean": MockProver(
                toy.cs, toy.assignment(*toy.witness_values(), device)
            ).verify() == [],
            "mock_names_sq": any(f.name == "sq"
                                 for f in MockProver(toy.cs, bad).verify())}


def toy_keys(circuit: str, srs, device=CUDA):
    """(toy, proving key) of one circuit of `TOY_CIRCUITS`."""
    toy = TOY_CIRCUITS[circuit][0]()
    return toy, keygen(srs, toy.cs, toy_key_assignment(circuit, toy, device))


def prove_toy(test: str, srs, pk, toy, rng, device=CUDA) -> dict:
    """One test of `TOY_TESTS` with the port: {"proof": bytes or None,
    "error": the ValueError's text or None, "outcomes": {check: bool}}.
    Only "range_out_of_range" may end in a ValueError (its `create_proof`
    must refuse the witness); "mixed" adds its two mock verdicts."""
    asg, instances = toy_witness(test, toy, device)
    try:
        proof = create_proof(srs, pk, asg, rng=rng)
    except ValueError as e:
        if test != "range_out_of_range":
            raise
        return {"proof": None, "error": str(e), "outcomes": {}}
    outcomes = toy_outcomes(
        test, lambda inst, p: verify_proof(srs, pk.vk, inst, p), instances,
        proof)
    if test == "mixed":
        outcomes.update(mixed_mock_outcomes(toy, device))
    return {"proof": proof, "error": None, "outcomes": outcomes}
