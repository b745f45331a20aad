"""ambigram_tpu_torch: the PyTorch/CUDA port of ambigram_tpu.

The JAX package `ambigram_tpu` stays the reference. This package runs
its single-case `--op bfb` path on an NVIDIA GPU: the scoring tensors,
the tiered device search and its host tail are PyTorch, and the Pallas
scorer is the hand-written CUDA kernel K1 (csrc/score_rows.cu). The
JAX-free host modules of `ambigram_tpu` (parsing, program building,
exact solvers, path replay) are imported, not copied. Nothing here
imports jax.
"""

__version__ = "0.1.0"
