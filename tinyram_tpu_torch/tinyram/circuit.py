"""TinyRamCircuit: assemble constraint system + assignments, prove, verify.

Port of `tinyram_tpu/tinyram/circuit.py` on the PyTorch PLONK core.
Tensors live on the SRS's device; `assignment`, `mock_prove` and
`gen_proof_and_verify` run on the card unless given another device.
"""

from __future__ import annotations

import secrets

from ..ipa import SRS, setup
from ..ipa.ipa import COMMIT_CHUNK
from ..plonk import Assignment, MockProver, create_proof, keygen, verify_proof
from ..plonk.keygen import ProvingKey
from ..utils.device import CUDA
from ..utils.profiling import span
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

    def assignment(self, trace: Trace, device=CUDA,
                   host: bool = False) -> Assignment:
        """Full assignment (fixed + advice + instance) for one trace,
        encoded on `device`; with `host`, each column rests in host memory
        once encoded (`Assignment`).  Its steps are the spans
        "witness.fixed", "witness.exe", "witness.instance" and
        "witness.encode" (`utils.profiling`)."""
        asg = Assignment(self.tcs.cs, self.tcs.n, device, host=host)
        with span("witness.fixed"):
            self._set_fixed(asg)
        with span("witness.exe"):
            cols = exe_witness(self.tcs, trace)
        with span("witness.encode"):
            for name, arr in cols.items():
                asg.set(self.tcs.col.advice[name], arr)
            del cols  # the advice arrays on the host
        with span("witness.instance"):
            cols = instance_columns(
                self.tcs, trace.prog, trace.answer,
                primary=trace.primary_tape, aux_len=trace.aux_len)
        with span("witness.encode"):
            for name, arr in cols.items():
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

    def keygen(self, srs: SRS, commit_chunk: int = COMMIT_CHUNK,
               host: bool = False) -> ProvingKey:
        """The key; `host` keeps its fixed Lagrange columns in host memory
        (`plonk.keygen`).  Only the fixed columns are assigned: keygen reads
        nothing else (zero-filling the advice and instance columns, as
        `finalize` would, held 36 GiB at config 4)."""
        asg = Assignment(self.tcs.cs, self.tcs.n, srs.device)
        self._set_fixed(asg)
        return keygen(srs, self.tcs.cs, asg, commit_chunk=commit_chunk,
                      host=host)

    def prove(self, srs: SRS, pk: ProvingKey, trace: Trace, rng=secrets,
              **knobs) -> bytes:
        """``knobs``: create_proof's ext_chunk / gate_slab / commit_chunk."""
        return create_proof(srs, pk, self.assignment(trace, srs.device),
                            rng=rng, **knobs)

    def verify(
        self, srs: SRS, pk: ProvingKey, prog: Program, answer: int,
        proof: bytes, primary=(), aux_len: int = 0,
        commit_chunk: int = COMMIT_CHUNK,
    ) -> bool:
        return verify_proof(
            srs, pk.vk,
            self.instance_arrays(prog, answer, primary, aux_len), proof,
            commit_chunk=commit_chunk,
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
