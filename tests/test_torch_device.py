"""The port's entry points run on the card unless the caller asks for
another device: their default is `torch.device("cuda")`, and where there is
no card a default call raises instead of running on the CPU."""

import inspect
import os

import numpy as np
import pytest
import torch

from tinyram_tpu_torch import convert
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.plonk import Assignment, load_pk, save_pk
from tinyram_tpu_torch.poly.domain import Domain
from tinyram_tpu_torch.tinyram import (
    Imm,
    Instruction,
    TinyRamCircuit,
    eval_program,
    gen_proof_and_verify,
)
from tinyram_tpu_torch.tinyram.mem import MemCS

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_w8.npz")
ANSWER = [Instruction("Answer", None, None, Imm(0))]


def _entry_points():
    circ = TinyRamCircuit(8, 8)
    trace = eval_program(ANSWER, 8, 8)
    rec = dict(np.load(GOLDEN))
    rec["fixed_commitments"] = convert.points_from_bytes(
        rec["fixed_comm"], rec["fixed_comm_none"])
    return {
        "setup": (setup, lambda: setup(3)),
        "gen_proof_and_verify": (gen_proof_and_verify,
                                 lambda: gen_proof_and_verify(8, 8, ANSWER)),
        "assignment": (TinyRamCircuit.assignment,
                       lambda: circ.assignment(trace)),
        "mock_prove": (TinyRamCircuit.mock_prove,
                       lambda: circ.mock_prove(trace)),
        "Assignment": (Assignment.__init__,
                       lambda: Assignment(circ.tcs.cs, circ.tcs.n)),
        "Domain": (Domain.__init__, lambda: Domain(FP, 3, 4)),
        "limbs": (convert.limbs, lambda: convert.limbs(rec["fixed_lag"][0])),
        "pk_from_numpy": (convert.pk_from_numpy,
                          lambda: convert.pk_from_numpy(rec, circ.tcs.cs)),
        "srs_from_numpy": (convert.srs_from_numpy, lambda: convert.srs_from_numpy(
            rec["fixed_lag"][0][:, :4], rec["fixed_lag"][1][:, :4],
            rec["fixed_lag"][2][:, :4], (1, 2), (3, 4))),
        "MemCS.witness": (MemCS.witness, lambda: MemCS(8).witness(trace)),
        "load_pk": (load_pk, None),
    }


NAMES = sorted(_entry_points())


@pytest.mark.parametrize("name", NAMES)
def test_entry_point_defaults_to_the_card(name, tmp_path):
    fn, call = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == \
        torch.device("cuda")
    if torch.cuda.is_available():
        return  # with a card the default call runs there (tests/test_torch_cuda.py)
    if call is None:  # load_pk: a key file saved from the CPU
        circ = TinyRamCircuit(8, 8)
        rec = dict(np.load(GOLDEN))
        rec["fixed_commitments"] = convert.points_from_bytes(
            rec["fixed_comm"], rec["fixed_comm_none"])
        path = str(tmp_path / "pk.npz")
        save_pk(path, convert.pk_from_numpy(rec, circ.tcs.cs, device="cpu"))
        call = lambda: load_pk(path, circ.tcs.cs)  # noqa: E731
    with pytest.raises((AssertionError, RuntimeError)):
        call()
