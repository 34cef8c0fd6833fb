"""Memory-consistency table (standalone circuit).

Port of `tinyram_tpu/tinyram/mem.py`: the access log sorted by (address,
time), with even-bits-range-checked address/time increments enforcing sort
order, init rows only at cycle starts, and loads preserving values.  Like
the reference it is standalone, not wired into TinyRamCircuit.

The load-preserves-value constraint gates on the *next* row being a load
(`load_next·(value_next − value)`), as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..plonk.circuit import Assignment, ConstraintSystem
from ..plonk.expr import Const
from ..utils.device import CUDA
from .emulator import Trace
from .exe import decomp_even_odd, spread_np


class MemCS:
    def __init__(self, word_bits: int):
        self.word_bits = word_bits
        self.table_len = 1 << (word_bits // 2)
        self.k = 2 + word_bits // 2
        self.n = 1 << self.k
        cs = self.cs = ConstraintSystem()
        cs.blinding_factors = 6  # ZK blinding rows (see exe.py)
        f, a = {}, {}
        for nm in ("s_table", "t_even"):
            f[nm] = cs.fixed_column(nm)
        for nm in (
            "s_trace", "address", "time", "init", "store", "load", "value",
            "addr_inc", "addr_inc_e", "addr_inc_o",
            "time_inc", "time_inc_e", "time_inc_o",
        ):
            a[nm] = cs.advice_column(nm)
        self.fixed, self.advice = f, a

        st = f["s_table"].cur()
        tr_n = a["s_trace"].next()
        sel = st * tr_n
        addr, addr_n = a["address"].cur(), a["address"].next()
        time, time_n = a["time"].cur(), a["time"].next()
        same_cycle = addr_n - addr
        end_cycle = addr_n - addr - Const(1) - a["addr_inc"].next()
        time_sorted = time_n - time - a["time_inc"].next()
        cs.gate(
            "mem",
            [
                sel * end_cycle * same_cycle,
                sel * end_cycle * time_sorted,
                sel * end_cycle * a["init"].next(),
                sel * a["load"].next() * (a["value"].next() - a["value"].cur()),
            ],
        )
        # increments are range-checked words (decompose + table lookups)
        for w in ("addr_inc", "time_inc"):
            dsel = st * a["s_trace"].cur()
            cs.gate(
                f"decomp.{w}",
                dsel * (a[f"{w}_e"].cur() + 2 * a[f"{w}_o"].cur() - a[w].cur()),
            )
            for part in ("_e", "_o"):
                cs.lookup(
                    f"eb.{w}{part}",
                    [dsel * a[f"{w}{part}"].cur()],
                    [f["t_even"].cur()],
                )

    # ------------------------------------------------------------- witness

    def witness(self, trace: Trace, device=CUDA) -> Assignment:
        W = self.word_bits
        n = self.n
        # sort accesses by (address, init-first, time)
        order = sorted(
            trace.accesses,
            key=lambda ac: (ac.address, 0 if ac.kind == "init" else 1, ac.time),
        )
        T = len(order)
        assert T <= self.table_len - 1, "access log too long for table"
        cols = {nm: np.zeros(n, dtype=np.int64) for nm in self.advice}
        prior_addr = 0
        prior_time = 0
        for i, ac in enumerate(order):
            new_cycle = i == 0 or ac.address != order[i - 1].address
            if new_cycle:
                prior_time = 0
            cols["s_trace"][i] = 1
            cols["address"][i] = ac.address
            cols["time"][i] = ac.time
            cols["init"][i] = 1 if ac.kind == "init" else 0
            cols["store"][i] = 1 if ac.kind == "store" else 0
            cols["load"][i] = 1 if ac.kind == "load" else 0
            cols["value"][i] = ac.value
            inc = max(ac.address - prior_addr - 1, 0)
            cols["addr_inc"][i] = inc if new_cycle else 0
            cols["time_inc"][i] = max(ac.time - prior_time, 0)
            prior_addr = ac.address
            prior_time = ac.time
        for w in ("addr_inc", "time_inc"):
            e, o = decomp_even_odd(cols[w], W)
            cols[f"{w}_e"] = e
            cols[f"{w}_o"] = o

        asg = Assignment(self.cs, n, device)
        s_table = np.zeros(n, dtype=np.int64)
        s_table[: self.table_len] = 1
        t_even = np.zeros(n, dtype=np.int64)
        t_even[: self.table_len] = spread_np(np.arange(self.table_len), W)
        asg.set(self.fixed["s_table"], s_table)
        asg.set(self.fixed["t_even"], t_even)
        for nm, arr in cols.items():
            asg.set(self.advice[nm], arr)
        asg.finalize()
        return asg
