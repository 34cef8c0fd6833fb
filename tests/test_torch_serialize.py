"""Proving-key files (.npz) across the two packages.

On the toy circuit of tests/test_plonk.py (k=3, with σ columns from its
copy constraint): a key saved by the JAX package loads in the port equal to
the port's own keygen, a key saved by the port loads in the JAX package
equal to the JAX keygen, and both files have the same keys and dtypes.  The
recorded W=8 TinyRAM key (tests/data/torch_golden_w8.npz) round-trips
through the port.
"""

import os

import numpy as np
import pytest
import torch

import tinyram_tpu.plonk as jplonk
import tinyram_tpu_torch.plonk as tplonk
from tinyram_tpu.ipa import setup as jsetup
from tinyram_tpu_torch.convert import pk_from_numpy, points_from_bytes
from tinyram_tpu_torch.ipa import setup
from tinyram_tpu_torch.tinyram import TinyRamCircuit

from test_torch_mock import K, toy

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_golden_w8.npz")
LIMB_LISTS = ("fixed_lag", "fixed_coeff", "sigma_lag", "sigma_coeff")


def _host(cols):
    return [np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c)
            .astype(np.int64) for c in cols]


def assert_same_key(a, b):
    """Two proving keys (either package) hold the same key."""
    assert (a.vk.k, a.vk.extended_k) == (b.vk.k, b.vk.extended_k)
    assert a.vk.fixed_commitments == b.vk.fixed_commitments
    assert a.vk.sigma_commitments == b.vk.sigma_commitments
    assert [(c.kind, c.index) for c in a.vk.perm_columns] == \
        [(c.kind, c.index) for c in b.vk.perm_columns]
    for name in LIMB_LISTS:
        x, y = _host(getattr(a, name)), _host(getattr(b, name))
        assert len(x) == len(y), name
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v, err_msg=name)


@pytest.fixture(scope="module")
def keys():
    jcs, jasg, _ = toy(jplonk)
    tcs, tasg, _ = toy(tplonk, device="cpu")
    jpk = jplonk.keygen(jsetup(K), jcs, jasg)
    tpk = tplonk.keygen(setup(K, device="cpu"), tcs, tasg)
    assert tpk.sigma_lag, "the toy circuit has σ columns"
    return jcs, jpk, tcs, tpk


def test_jax_file_loads_in_port(keys, tmp_path):
    jcs, jpk, tcs, tpk = keys
    path = str(tmp_path / "jax_pk.npz")
    jplonk.save_pk(path, jpk)
    loaded = tplonk.load_pk(path, tcs, device="cpu")
    assert_same_key(loaded, tpk)
    assert loaded.domain.device == torch.device("cpu")
    assert all(c.dtype == torch.int32 for c in loaded.fixed_lag + loaded.sigma_lag)


def test_port_file_loads_in_jax(keys, tmp_path):
    jcs, jpk, tcs, tpk = keys
    path = str(tmp_path / "port_pk.npz")
    tplonk.save_pk(path, tpk)
    assert_same_key(jplonk.load_pk(path, jcs), jpk)
    jplonk.save_pk(str(tmp_path / "jax_pk.npz"), jpk)
    ours, theirs = np.load(path), np.load(str(tmp_path / "jax_pk.npz"))
    assert sorted(ours.files) == sorted(theirs.files)
    for key in theirs.files:
        assert ours[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


def test_recorded_w8_key_round_trips(tmp_path):
    rec = dict(np.load(GOLDEN))
    rec["fixed_commitments"] = points_from_bytes(rec["fixed_comm"],
                                                 rec["fixed_comm_none"])
    circ = TinyRamCircuit(8, 8)
    pk = pk_from_numpy(rec, circ.tcs.cs, device="cpu")
    path = str(tmp_path / "w8.npz")
    tplonk.save_pk(path, pk)
    back = tplonk.load_pk(path, circ.tcs.cs, device="cpu")
    assert_same_key(back, pk)
    np.testing.assert_array_equal(np.load(path)["fixed_lag"],
                                  rec["fixed_lag"].astype(np.uint32))
