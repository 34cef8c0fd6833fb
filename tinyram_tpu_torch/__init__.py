"""tinyram_tpu_torch: the tinyram-tpu prover ported to PyTorch and CUDA.

The JAX package `tinyram_tpu` stays the reference; this package mirrors its
layout module for module.  Field elements keep the reference's `(16, *batch)`
layout (16-bit limbs, Montgomery form, R = 2^256), stored as `torch.int32`.
On a CUDA tensor the six kernels of the reference's Pallas code run as
hand-written Hopper kernels (`csrc/`, built by `kernels.py`); on a CPU tensor
each kernel's wrapper runs its plain PyTorch version.  This package never
imports JAX.
"""

__version__ = "0.1.0"
