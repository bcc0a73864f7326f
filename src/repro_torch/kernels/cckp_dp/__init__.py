"""The CCKP dynamic-program kernel of AMDP: `ops` (CUDA wrapper with its
launch counter) and `ref` (its plain PyTorch version)."""
