"""Wrapper around the CUDA CCKP kernel (`csrc/cckp_dp.cu`).

`model_dp` runs one model group of AMDP's dynamic program over a batch of
value grids, each lane with its own integerized time ``p``.  On a CUDA
tensor it launches the hand-written kernel, built at first use with
``nvcc`` into ``build/kernels/`` of the checkout and bound with `ctypes`;
on a CPU tensor it runs the plain PyTorch version in `ref.py`.  There is
no fallback: a CUDA tensor gets the kernel or an exception.  Only a kernel
launch adds one to ``model_dp.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, check_tensor, raise_on, stream_of
from .ref import cckp_model_dp_ref


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cckp_model_dp_launch.argtypes = [P, P, P, P, P, I, I, I, I, P]
    lib.cckp_model_dp_launch.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" / "cckp_dp.cu",
                  _declare)


def library() -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


def model_dp(y: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
             n_steps: int):
    """One CCKP model group on every lane: ``y`` (B, T1, K1) float32,
    ``p`` (B,) int32 >= 0, ``a`` (B,) float32.  Returns new tensors
    ``(y' float32, bestq int32)`` of ``y``'s shape (see `ref.py`)."""
    if y.device.type == "cpu":
        return cckp_model_dp_ref(y, p, a, n_steps)
    if y.device.type != "cuda":
        raise ValueError(f"no cckp_model_dp kernel for {y.device}")
    B, T1, K1 = y.shape
    dev = y.device
    check_tensor("y", y, torch.float32, (B, T1, K1), dev)
    check_tensor("p", p, torch.int32, (B,), dev)
    check_tensor("a", a, torch.float32, (B,), dev)
    out = torch.empty_like(y)
    bestq = torch.empty((B, T1, K1), dtype=torch.int32, device=dev)
    err = library().cckp_model_dp_launch(
        y.data_ptr(), p.data_ptr(), a.data_ptr(), out.data_ptr(),
        bestq.data_ptr(), B, T1, K1, int(n_steps), stream_of(dev))
    raise_on(err, "cckp_model_dp")
    model_dp.launches += 1
    return out, bestq


model_dp.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    model_dp.launches = 0
