"""The flash attention forward kernel of the dense LM: `ops` (CUDA wrappers
with their launch counter) and `ref` (the plain PyTorch version)."""
