"""The k = 6 toy circuit of the JAX package's sharded dry run.

The circuit and witness of `__graft_entry__.dryrun_multichip` and
`tests/test_shard_prover.py` (`build_cs`, `_witness`): y = x² under a
fixed selector, y bound to the public input, a fixed-table range lookup of
x into [0, 16) and one copy constraint (x repeats on the first two rows):
one of every argument family, small enough to prove on a CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..field.field import FP
from ..utils.device import CUDA
from .circuit import Assignment, Column, ConstraintSystem

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

    def fixed_assignment(self, device=CUDA) -> Assignment:
        """The fixed columns alone: what `keygen` takes."""
        asg = Assignment(self.cs, N, device)
        u = self.usable
        asg.set(self.q, [1] * u + [0] * (N - u))
        asg.set(self.t_rng, list(range(16)) + [0] * (N - 16))
        return asg

    def witness_values(self) -> list[int]:
        """x on the usable rows: 3, 3 (the copy), then (7 i) mod 16."""
        return [3, 3] + [(i * 7) % 16 for i in range(2, self.usable)]

    def public_values(self, xs: list[int]) -> list[int]:
        return [v * v % P for v in xs] + [0] * (N - len(xs))

    def assignment(self, device=CUDA) -> Assignment:
        """The full assignment: x = `witness_values()`, y = x², and y in
        the public column."""
        xs = self.witness_values()
        asg = self.fixed_assignment(device)
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
