"""TinyRamCircuit: assemble constraint system + assignments, prove, verify.

Port of `tinyram_tpu/tinyram/circuit.py` on the PyTorch PLONK core.
Tensors live on the SRS's device; `assignment`, `mock_prove` and
`gen_proof_and_verify` run on the card unless given another device.
"""

from __future__ import annotations

import secrets

from ..ipa import SRS, setup
from ..plonk import Assignment, MockProver, create_proof, keygen, verify_proof
from ..plonk.keygen import ProvingKey
from ..utils.device import CUDA
from .emulator import Trace, eval_program
from .exe import TinyRamCS, exe_witness, fixed_columns, instance_columns
from .isa import Program


class TinyRamCircuit:
    def __init__(self, word_bits: int, reg_count: int, k: int | None = None):
        """``k`` > 2 + W/2 decouples trace capacity from the word size."""
        self.tcs = TinyRamCS(word_bits, reg_count, k=k)

    @property
    def k(self) -> int:
        return self.tcs.k

    def _set_fixed(self, asg: Assignment) -> None:
        for name, arr in fixed_columns(self.tcs).items():
            asg.set(self.tcs.col.fixed[name], arr)

    def assignment(self, trace: Trace, device=CUDA) -> Assignment:
        """Full assignment (fixed + advice + instance) for one trace."""
        asg = Assignment(self.tcs.cs, self.tcs.n, device)
        self._set_fixed(asg)
        for name, arr in exe_witness(self.tcs, trace).items():
            asg.set(self.tcs.col.advice[name], arr)
        for name, arr in instance_columns(
            self.tcs, trace.prog, trace.answer,
            primary=trace.primary_tape, aux_len=trace.aux_len,
        ).items():
            asg.set(self.tcs.col.instance[name], arr)
        asg.finalize()
        return asg

    def instance_arrays(
        self, prog: Program, answer: int, primary=(), aux_len: int = 0
    ) -> list:
        """Instance column value lists in column-index order (verifier)."""
        byname = instance_columns(self.tcs, prog, answer, primary, aux_len)
        out = [None] * self.tcs.cs.num_instance
        for name, colh in self.tcs.col.instance.items():
            out[colh.index] = [int(v) for v in byname[name]]
        return out

    def mock_prove(self, trace: Trace, device=CUDA) -> list:
        """MockProver failures (empty = satisfied); mirrors
        MockProver::assert_satisfied usage (circuits/mod.rs:364-375)."""
        return MockProver(self.tcs.cs, self.assignment(trace, device)).verify()

    def keygen(self, srs: SRS) -> ProvingKey:
        asg = Assignment(self.tcs.cs, self.tcs.n, srs.device)
        self._set_fixed(asg)
        asg.finalize()
        return keygen(srs, self.tcs.cs, asg)

    def prove(self, srs: SRS, pk: ProvingKey, trace: Trace, rng=secrets,
              **knobs) -> bytes:
        """``knobs``: create_proof's ext_chunk / gate_slab / commit_chunk."""
        return create_proof(srs, pk, self.assignment(trace, srs.device),
                            rng=rng, **knobs)

    def verify(
        self, srs: SRS, pk: ProvingKey, prog: Program, answer: int,
        proof: bytes, primary=(), aux_len: int = 0,
    ) -> bool:
        return verify_proof(
            srs, pk.vk,
            self.instance_arrays(prog, answer, primary, aux_len), proof,
        )


def gen_proof_and_verify(
    word_bits: int, reg_count: int, prog: Program, primary=(), aux=(),
    device=CUDA, rng=secrets,
):
    """End-to-end helper: emulate, set up, keygen, prove, verify."""
    circuit = TinyRamCircuit(word_bits, reg_count)
    trace = eval_program(prog, word_bits, reg_count, primary, aux)
    srs = setup(circuit.k, device)
    pk = circuit.keygen(srs)
    proof = circuit.prove(srs, pk, trace, rng=rng)
    ok = circuit.verify(
        srs, pk, prog, trace.answer, proof,
        primary=primary, aux_len=len(list(aux)),
    )
    return trace, proof, ok
