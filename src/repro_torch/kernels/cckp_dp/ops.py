"""Wrappers around the CUDA CCKP kernel (`csrc/cckp_dp.cu`).

* `models_dp(y, p, a, n_steps)` runs the m model groups of one AMDP call
  over a batch of value grids, each lane with its own integerized times
  ``p[b]`` and accuracies ``a[b]``: one kernel launch, the intermediate
  grids kept on chip.
* `model_dp(y, p, a, n_steps)` runs one model group: the same kernel with
  m = 1.

On a CUDA tensor they launch the hand-written kernel, built at first use
with ``nvcc`` into ``build/kernels/`` of the checkout and bound with
`ctypes`; the wrapper takes the kernel's shared-memory instance when a
lane's grid and stage fit a block's shared memory, and its global-memory
instance otherwise (`uses_shared`).  On a CPU tensor they run the plain
PyTorch versions in `ref.py`.  There is no fallback: a CUDA tensor gets
the kernel or an exception.  Only a kernel launch adds one to
``models_dp.launches``, whichever entry launched it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from .._build import Library, check_tensor, raise_on, stream_of
from .ref import cckp_model_dp_ref, cckp_models_dp_ref

STAGE_ROWS = 256            # rows of one block of the update (kThreads)


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cckp_models_dp_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I,
                                          I, I, P]
    lib.cckp_models_dp_launch.restype = I
    lib.cckp_dp_smem_bytes.argtypes = [I, I, I, I]
    lib.cckp_dp_smem_bytes.restype = ctypes.c_longlong
    lib.cckp_dp_max_shared.argtypes = [P]
    lib.cckp_dp_max_shared.restype = I
    lib.cckp_dp_occupancy.argtypes = [I, I, I, I, P]
    lib.cckp_dp_occupancy.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" / "cckp_dp.cu",
                  _declare)
_MAX_SHARED: Dict[int, int] = {}        # opt-in shared memory by device


def library() -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


def smem_bytes(T1: int, K1: int, n_steps: int, shared: bool) -> int:
    """Bytes of shared memory one CTA takes for a (T1, K1) grid walked
    over ``n_steps``: the q·a table (min(n_steps, K1) floats) and, in the
    shared instance, the lane's grid and a stage of `STAGE_ROWS` rows of
    values and counts."""
    floats = max(0, min(n_steps, K1))
    if shared:
        floats += T1 * K1 + 2 * STAGE_ROWS * K1
    return 4 * floats


def _max_shared(device: torch.device) -> int:
    """A block's opt-in shared memory on ``device``, in bytes."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _MAX_SHARED:
        lib = library()
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            raise_on(lib.cckp_dp_max_shared(ctypes.byref(out)),
                     "cckp_dp_max_shared")
        _MAX_SHARED[index] = out.value
    return _MAX_SHARED[index]


def uses_shared(T1: int, K1: int, n_steps: int,
                device: torch.device) -> bool:
    """Whether a (T1, K1) grid takes the shared-memory instance on
    ``device``: its `smem_bytes` fit the block's opt-in limit."""
    return smem_bytes(T1, K1, n_steps, True) <= _max_shared(device)


def occupancy(T1: int, K1: int, n_steps: int, shared: bool) -> int:
    """CTAs of one instance that fit an SM of the current device for a
    (T1, K1) grid (the CUDA occupancy calculator)."""
    out = ctypes.c_int(0)
    raise_on(library().cckp_dp_occupancy(T1, K1, n_steps, int(shared),
                                         ctypes.byref(out)),
             "cckp_dp_occupancy")
    return out.value


def models_dp(y: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
              n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The m CCKP model groups of one AMDP call on every lane, model after
    model: ``y`` (B, T1, K1) float32, ``p`` (B, m) int32 >= 0, ``a`` (B,
    m) float32.  Returns new tensors ``(y_final (B, T1, K1) float32,
    bestq (m, B, T1, K1) int32)``, ``bestq[i]`` the argmax table of model
    i (see `ref.py`)."""
    if y.device.type == "cpu":
        return cckp_models_dp_ref(y, p, a, n_steps)
    if y.device.type != "cuda":
        raise ValueError(f"no cckp_model_dp kernel for {y.device}")
    if y.dim() != 3 or p.dim() != 2:
        raise ValueError(f"models_dp takes y (B, T1, K1) and p, a (B, m); "
                         f"got {tuple(y.shape)}, {tuple(p.shape)}")
    B, T1, K1 = y.shape
    m = p.shape[1]
    dev = y.device
    check_tensor("y", y, torch.float32, (B, T1, K1), dev)
    check_tensor("p", p, torch.int32, (B, m), dev)
    check_tensor("a", a, torch.float32, (B, m), dev)
    if T1 * K1 >= 2 ** 31:
        raise ValueError(f"a lane's grid of {T1} x {K1} cells is too large")
    out = torch.empty_like(y)
    bestq = torch.empty((m, B, T1, K1), dtype=torch.int32, device=dev)
    shared = uses_shared(T1, K1, n_steps, dev)
    if not shared and smem_bytes(T1, K1, n_steps, False) > _max_shared(dev):
        raise ValueError(f"n_steps {n_steps} and K1 {K1} leave no room for "
                         f"the q·a table in shared memory")
    if shared:
        vscratch = qscratch = None
    else:
        vscratch = torch.empty((B, STAGE_ROWS * K1), dtype=torch.float32,
                               device=dev)
        qscratch = torch.empty((B, STAGE_ROWS * K1), dtype=torch.int32,
                               device=dev)
    err = library().cckp_models_dp_launch(
        y.data_ptr(), p.data_ptr(), a.data_ptr(), out.data_ptr(),
        bestq.data_ptr(), 0 if shared else vscratch.data_ptr(),
        0 if shared else qscratch.data_ptr(), B, T1, K1, m, int(n_steps),
        int(shared), stream_of(dev))
    raise_on(err, "cckp_model_dp")
    models_dp.launches += 1
    return out, bestq


models_dp.launches = 0


def model_dp(y: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
             n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One CCKP model group on every lane: ``y`` (B, T1, K1) float32,
    ``p`` (B,) int32 >= 0, ``a`` (B,) float32.  Returns new tensors
    ``(y' float32, bestq int32)`` of ``y``'s shape (see `ref.py`): the
    kernel of `models_dp` with m = 1."""
    if y.device.type == "cpu":
        return cckp_model_dp_ref(y, p, a, n_steps)
    if p.dim() != 1 or a.dim() != 1:
        raise ValueError(f"model_dp takes p and a of shape (B,); got "
                         f"{tuple(p.shape)}, {tuple(a.shape)}")
    out, bestq = models_dp(y, p[:, None], a[:, None], n_steps)
    return out, bestq[0]


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    models_dp.launches = 0
