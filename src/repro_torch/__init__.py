"""PyTorch/CUDA port of the `repro` fleet planner for NVIDIA Hopper.

`repro` (the JAX package beside this one) is the reference.  This package
mirrors its layout (`core/`, `kernels/`, `serving/`, `api/`) and grows
slice by slice; what is ported so far is the fleet engine's base AMR^2
rollout (`api.engine.rollout`) with its two simplex kernels written in
CUDA C++ for `sm_90a` (`kernels/simplex_pivot`).

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit device they raise
(`_device.resolve_device`).  On CPU tensors the kernels' plain PyTorch
versions run instead, which is how the parity tests hold the port against
the reference.

The package imports torch, numpy and the standard library only — never
`jax` and never `repro`.
"""
