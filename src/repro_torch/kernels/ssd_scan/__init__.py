"""The Mamba2 SSD chunked scan kernel: `ops` (CUDA wrappers with their
launch counter) and `ref` (the plain PyTorch versions)."""
