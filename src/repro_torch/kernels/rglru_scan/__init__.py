"""The RG-LRU linear recurrence kernel of recurrentgemma's recurrent
block: `ops` (the CUDA wrapper with its launch counter) and `ref` (the
plain PyTorch versions)."""
