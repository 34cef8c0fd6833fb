"""The port's layout dumps (tinyram_tpu_torch.plonk.layout) equal the JAX
package's, string for string, on the W=8 TinyRAM constraint system and on
the memory table's."""

import pytest

from tinyram_tpu.plonk import layout_dot as jdot
from tinyram_tpu.plonk import layout_summary as jsummary
from tinyram_tpu.tinyram import TinyRamCircuit as JCircuit
from tinyram_tpu.tinyram.mem import MemCS as JMemCS
from tinyram_tpu_torch.plonk import layout_dot, layout_summary
from tinyram_tpu_torch.plonk.layout import expr_str
from tinyram_tpu_torch.tinyram import TinyRamCircuit
from tinyram_tpu_torch.tinyram.mem import MemCS

CASES = {
    "tinyram_w8": (lambda: TinyRamCircuit(8, 8).tcs.cs,
                   lambda: JCircuit(8, 8).tcs.cs),
    "mem_w8": (lambda: MemCS(8).cs, lambda: JMemCS(8).cs),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dump", ["summary", "dot"])
def test_layout_strings_equal_jax(case, dump):
    port_cs, jax_cs = (make() for make in CASES[case])
    port_fn, jax_fn = {"summary": (layout_summary, jsummary),
                       "dot": (layout_dot, jdot)}[dump]
    got, want = port_fn(port_cs), jax_fn(jax_cs)
    assert got == want
    assert len(got.splitlines()) > 10


def test_expr_str_without_names():
    cs = MemCS(8).cs
    assert expr_str(cs.gates[0].polys[0]).startswith("fixed0*advice0[+1]")
