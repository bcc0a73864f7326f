"""Wrapper around the CUDA RG-LRU recurrence kernel (`csrc/rglru_scan.cu`).

`rglru_scan_fwd(a, b)` takes the Pallas function's layout: a and b
(B, S, W) float32, contiguous; it returns the hidden sequence h (B, S, W)
float32 with ``h_t = a_t h_{t-1} + b_t`` and ``h_{-1} = 0``.
`rglru_scan(a, b)` is the reference wrapper's name for the same call.
Shapes, type and contiguity are checked on every device.

On a CUDA tensor the hand-written kernel runs, built at first use with
``nvcc`` into ``build/kernels/`` of the checkout and bound with `ctypes`;
on a CPU tensor the plain log-step scan in `ref.py` runs; any other device
raises.  There is no fallback: a CUDA tensor gets the kernel or an
exception.  Only a kernel launch adds one to ``rglru_scan_fwd.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, check_tensor, raise_on, stream_of
from .ref import rglru_scan_ref


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_fwd_launch.argtypes = [P, P, P, I, I, I, P]
    lib.rglru_scan_fwd_launch.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu",
                  _declare)


def library() -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, S, W) float32 -> h (B, S, W) float32."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be one (B, S, W) shape")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan takes float32, got {name} "
                            f"{t.dtype}")
        if not t.is_contiguous():        # on every device: the kernel's
            raise ValueError(f"{name} must be contiguous")   # layout
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no rglru_scan kernel for {a.device}")
    check_tensor("b", b, torch.float32, tuple(a.shape), a.device)
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    Bb, S, W = a.shape
    err = library().rglru_scan_fwd_launch(a.data_ptr(), b.data_ptr(),
                                          h.data_ptr(), Bb, S, W,
                                          stream_of(a.device))
    raise_on(err, "rglru_scan_fwd")
    rglru_scan_fwd.launches += 1
    return h


rglru_scan_fwd.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    rglru_scan_fwd.launches = 0


rglru_scan = rglru_scan_fwd             # the reference wrapper's name
