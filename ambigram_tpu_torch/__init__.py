"""ambigram_tpu_torch: the PyTorch/CUDA port of ambigram_tpu.

The JAX package `ambigram_tpu` stays the reference. This package runs
every op of its CLI (`bfb` and single-cell `sc_bfb`, on one case or a
manifest through the case-stacked batch search, and the host-only
legacy `check`/`solve`) and the bench on an NVIDIA GPU: the scoring
tensors, the tiered device search and its host tail are PyTorch, and
the Pallas kernels are the hand-written CUDA kernels K1
(csrc/score_rows.cu) and K2 (csrc/chained_score.cu). It is
self-contained: it imports neither jax nor anything of `ambigram_tpu`,
and keeps its own copies of the host modules it runs (parsing, program
building, the exact solvers, path replay, the simulator, the legacy
balancer and traversal) at the same module paths.
"""

__version__ = "0.1.0"
