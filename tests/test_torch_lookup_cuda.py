"""The lookups' sort-and-match (`plonk/lookup_rank.py`) on the card against
the same code on the CPU, at config 3's shapes (9 plookups of 2^17 rows,
one LogUp argument of 25 input columns); and a config-2 proof that ranks
every lookup on the card (the counters "lookup.permute.card" and
"lookup.multiplicity.card" of `utils.profiling.counters`).

Every test here needs an NVIDIA GPU: without one each skips (decided in the
`dev` fixture, not at import).  The machine with the card has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_lookup_cuda.py

`tests/test_torch_lookup_permute.py` holds the CPU version to the JAX
package's host rules on the CPU.  Tolerance 0: indices and counts are
integers.
"""

import numpy as np
import pytest
import torch

from tinyram_tpu_torch import kernels
from tinyram_tpu_torch.plonk import create_proof
from tinyram_tpu_torch.plonk.lookup_rank import logup_counts, plookup_sources
from tinyram_tpu_torch.shard.paths import SeededRng
from tinyram_tpu_torch.tinyram.prove_config import prove_config
from tinyram_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.cuda

U = (1 << 17) - 7  # config 3's usable rows (k = 17, 6 blinding factors)
LOOKUPS = 9
LOGUP_INPUTS = 25  # config 3's LogUp argument "eb"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    kernels.library()  # builds on first use; a failed build fails here
    return torch.device("cuda", 0)


def _pool(rng, m: int, small: bool) -> np.ndarray:
    """(16, m) canonical plain limbs: below 2^254, or below 2^40."""
    limbs = rng.integers(0, 1 << 16, size=(16, m), dtype=np.int64)
    limbs[15] &= 0x3FFF
    if small:
        limbs[3:] = 0
        limbs[2] &= 0xFF
    return limbs


def _columns(seed: int, u: int, small: bool) -> np.ndarray:
    """(16, 2, u): A drawn with heavy duplicates from part of S's values;
    S holds u // 3 values, some repeated, some A never uses."""
    rng = np.random.default_rng(seed)
    pool = _pool(rng, u // 3, small)
    s = np.concatenate([np.arange(u // 3), rng.integers(0, u // 3, u - u // 3)])
    rng.shuffle(s)
    a = s[np.minimum(rng.zipf(1.3, u) - 1, u // 5)]
    return np.stack([pool[:, a], pool[:, s]], axis=1)


@pytest.fixture(scope="module")
def pairs():
    """(16, 18, U) int32 on the CPU: seven lookups of wide values (the
    Python-int rule), two below 2^62 (the int64 rule)."""
    cols = [_columns(100 + i, U, small=i >= 7) for i in range(LOOKUPS)]
    return torch.as_tensor(np.concatenate(cols, axis=1).astype(np.int32))


def test_plookup_sources_on_the_card_equal_the_cpu(dev, pairs):
    want = plookup_sources(pairs)
    got = plookup_sources(pairs.to(dev))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("small", [True, False], ids=["below_2_40", "wide"])
def test_logup_counts_on_the_card_equal_the_cpu(dev, small):
    rng = np.random.default_rng(5)
    pool = _pool(rng, U // 2, small=small)
    t = np.concatenate([np.arange(U // 2), rng.integers(0, U // 2, U - U // 2)])
    ins = rng.integers(0, U // 4, size=(LOGUP_INPUTS, U))
    t_plain = torch.as_tensor(pool[:, t].astype(np.int32))
    in_plain = torch.as_tensor(pool[:, ins].astype(np.int32))
    want = logup_counts(in_plain, t_plain, "eb")
    got = logup_counts(in_plain.to(dev), t_plain.to(dev), "eb")
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)
    assert int(want[0].sum() + (want[1].sum() << 16)) == LOGUP_INPUTS * U


def test_a_config2_proof_ranks_every_lookup_on_the_card(dev):
    rep = prove_config(2, mock=False, device=dev, cache_dir=None,
                       rng=SeededRng(1), log=lambda *a: None)
    ob = rep["objects"]
    counters.ops.clear()
    counters.seconds.clear()
    create_proof(ob["srs"], ob["pk"], ob["asg"], rng=SeededRng(2))
    assert counters.ops["lookup.permute.card"] == LOOKUPS
    assert counters.ops["lookup.multiplicity.card"] == 1
