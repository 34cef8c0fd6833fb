"""Config 3's coset extension on the port's four-step NTT against the JAX
package, on the CPU: 2^17 coefficients to 2^19 evaluations on the coset,
split as the card splits it (rows of 2^10 points, then of 2^9, with the
cross multipliers between them; B2's plain rows here), limb for limb
against the JAX `Domain(k=17).coeff_to_extended` (tolerance 0).  A file of
its own: the JAX side alone takes over a minute on one CPU.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tinyram_tpu.field import FP as JFP
from tinyram_tpu.poly import Domain as JDomain
from tinyram_tpu_torch.field import FP
from tinyram_tpu_torch.poly import cuda_ntt, domain_cache
from tinyram_tpu_torch.poly.ntt import coeff_scale

torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them


def test_four_step_ntt_2_19_matches_jax_extended():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 16, size=(16, 1 << 17)).astype(np.int64)
    x[15] &= 0x3FFF  # < 2^254 < p
    dom = domain_cache("Fp", 17, 19, "cpu")
    xt = torch.as_tensor(x.astype(np.int32))
    padded = torch.cat([xt, FP.zeros((3 << 17,), "cpu")], dim=-1)
    got = cuda_ntt.ntt_cuda(FP, coeff_scale(FP, padded, dom.g_coset))
    want = JDomain(JFP, 17, 19).coeff_to_extended(jnp.asarray(x.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy().astype(np.int64) & 0xFFFFFFFF,
                                  np.asarray(want).astype(np.int64))
