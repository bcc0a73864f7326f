"""Batched simplex pivot kernels: `ops` (CUDA wrappers with launch
counters) and `ref` (their plain PyTorch versions)."""
