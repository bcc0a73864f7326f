"""The flash-decode attention kernel of the KV-cache decode path: `ops`
(CUDA wrappers with their launch counter) and `ref` (the plain PyTorch
version and the ring-buffer validity mask)."""
