"""bfbbench: the benchmark of ambigram_tpu_torch on an NVIDIA GPU (see README.md)."""
