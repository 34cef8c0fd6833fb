"""The two MSM CLIs of the port against the JAX package, on the CPU at 2^8
points: `python -m tinyram_tpu_torch.verify_signed_msm` (the twin of
scripts/verify_signed_msm.py) and `python -m
tinyram_tpu_torch.tune_msm_window` (the twin of scripts/tune_msm_window.py).

- The signed check's inputs are the JAX script's (the JAX package's
  `_hash_to_curve(b"signed", i)` points, the `Random(7)` scalars), and
  its Pippenger sums at c = 8 and 13 equal the JAX host oracle
  `tinyram_tpu.curve.host.msm` on them.  The run is made once, with the
  JAX oracle in place of the port's copy, so that the 256-point oracle
  (pure Python, ~18 s) is computed once; the bit-serial ladder check and
  the rate step run too.
- The window sweep's inputs are the JAX script's (the generators of
  `setup(8)`, the `default_rng(5)` limbs), its chooser's c is the JAX
  `choose_window_bits` (8), and its sums at c = 8 (the chooser's, run
  once) and c = 9 (run and timed) equal each other, the ladder's and the
  JAX host oracle's.

Tolerance 0: affine points equal.
"""

import io
import json
import random
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tinyram_tpu.curve import host as jhost
from tinyram_tpu.curve.msm import choose_window_bits as jax_choose
from tinyram_tpu.field import FP as JFP
from tinyram_tpu.ipa import srs as jsrs
from tinyram_tpu_torch import tune_msm_window, verify_signed_msm
from tinyram_tpu_torch.ipa.srs import CACHE_DIR, _hash_to_curve, setup

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

N = 256


def _hex(pt):
    return [hex(v) for v in pt]


def _json(capsys):
    return json.loads(capsys.readouterr().out.splitlines()[-1])


@pytest.fixture(scope="module")
def signed():
    """`verify_signed_msm --log-n 8 --rate-logs 8` with the JAX host
    oracle: (its JSON line, the oracle's (scalars, points, sum))."""
    heard = []

    def msm(scalars, points):
        heard.append((list(scalars), list(points), jhost.msm(scalars, points)))
        return heard[-1][2]

    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, redirect_stdout(printed):
        mp.setattr(verify_signed_msm, "host", types.SimpleNamespace(msm=msm))
        rc = verify_signed_msm.main(["--log-n", "8", "--rate-logs", "8",
                                     "--iters", "1", "--device", "cpu"])
    assert rc == 0 and len(heard) == 1
    return json.loads(printed.getvalue().splitlines()[-1]), heard[0]


def test_signed_inputs_are_the_jax_scripts(signed):
    """The 256 points are the JAX package's hash-to-curve points (and the
    port's), the scalars the JAX script's."""
    _, (scalars, points, _) = signed
    assert points == [jsrs._hash_to_curve(b"signed", i) for i in range(N)]
    assert points == [_hash_to_curve(b"signed", i) for i in range(N)]
    rng = random.Random(7)
    assert scalars == [0, 1, JFP.modulus - 1] + [
        rng.randrange(JFP.modulus) for _ in range(N - 3)]


def test_signed_pippenger_equals_the_jax_host_msm(signed):
    out, (_, _, want) = signed
    assert out["host_sum"] == _hex(want)
    assert sorted(out["oracle"]) == ["13", "8"]
    for c, v in out["oracle"].items():
        assert v["ok"] is True and v["sum"] == _hex(want), c
    assert out["ok"] is True


def test_signed_ladder_and_rate(signed):
    out, _ = signed
    assert out["ladder"] == {**out["ladder"], "log_n": 8,
                             "c": jax_choose(N), "ok": True}
    assert out["rates"]["8"]["points_per_s"] > 0


def test_every_window_gives_the_jax_host_sum(capsys):
    assert tune_msm_window.main(["8", "9", "--runs", "1",
                                 "--device", "cpu"]) == 0
    out = _json(capsys)
    assert out["chooser_c"] == jax_choose(N) == 8 and out["n"] == N
    assert list(out["windows"]) == ["9"]  # held against c = 8's sum
    assert all(w["equal"] and w["ms"] > 0 for w in out["windows"].values())
    assert out["small_equal"] is True and out["ok"] is True
    points = setup(8, "cpu", cache_dir=CACHE_DIR).g_host
    assert points == [jsrs._hash_to_curve(b"tinyram-tpu-srs-g", i)
                      for i in range(N)]
    limbs = tune_msm_window.scalars(N, "cpu").numpy().view("uint32")
    want = np.random.default_rng(5).integers(0, 1 << 16, size=(16, N))
    want[15] &= 0x3FFF  # the JAX script's draw
    assert np.array_equal(limbs, want)
    scalars = [sum(int(limbs[i, j]) << (16 * i) for i in range(16))
               for j in range(N)]
    assert out["sum"] == _hex(jhost.msm(scalars, points))
