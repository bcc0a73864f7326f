"""Wrappers around the CUDA simplex pivot kernels (`csrc/simplex_pivot.cu`).

`pivot_update` and `reduced_pivot` take the signatures `core.lp` calls
them with.  On a CUDA tensor they launch the hand-written kernel, built at
first use with ``nvcc`` into ``build/kernels/`` of the checkout and bound
with `ctypes`; on a CPU tensor they run the plain PyTorch version in
`ref.py`.  There is no fallback: a CUDA tensor gets the kernel or an
exception.

Both update their state IN PLACE (the kernels skip lanes that do not
pivot), and both wrappers keep the in-place contract on the CPU path too.
Each wrapper counts its kernel launches in a plain integer attribute
(``pivot_update.launches``, ``reduced_pivot.launches``); only a kernel
launch increments it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

from .ref import pivot_update_ref, reduced_pivot_ref

_SRC = Path(__file__).resolve().parent / "csrc" / "simplex_pivot.cu"
# <checkout>/build/kernels (this file is src/repro_torch/kernels/<pkg>/)
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of the CUDA compiler."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


def build() -> Tuple[Path, str]:
    """Compile the kernel source into a shared library named by its
    content hash (a changed source rebuilds; an unchanged one is reused).
    Returns ``(library path, nvcc/ptxas log)``; the log is empty when the
    library already existed."""
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    out = _BUILD_DIR / f"libsimplex_pivot_{digest[:16]}.so"
    if out.exists():
        return out, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SRC)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
        os.replace(tmp, out)             # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed and loaded once per
    process."""
    global _lib
    if _lib is None:
        path, _log = build()
        lib = ctypes.CDLL(str(path))
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.simplex_pivot_launch.argtypes = [P, P, P, P, I, I, I, P]
        lib.simplex_pivot_launch.restype = I
        lib.reduced_pivot_launch.argtypes = [P, P, P, P, P, P, P, P, P,
                                             I, I, I, D, D, P]
        lib.reduced_pivot_launch.restype = I
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def pivot_update(tabs: torch.Tensor, r: torch.Tensor, j: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Pivot every active lane of ``tabs`` (B, R+1, C+1) float64 in place
    on (r, j) (B,) int32; ``mask`` (B,) bool False lanes are untouched.
    Returns ``tabs``."""
    if tabs.device.type == "cpu":
        return tabs.copy_(pivot_update_ref(tabs, r, j, mask))
    if tabs.device.type != "cuda":
        raise ValueError(f"no simplex_pivot kernel for {tabs.device}")
    B, R1, C1 = tabs.shape
    dev = tabs.device
    _check("tabs", tabs, torch.float64, (B, R1, C1), dev)
    _check("r", r, torch.int32, (B,), dev)
    _check("j", j, torch.int32, (B,), dev)
    _check("mask", mask, torch.bool, (B,), dev)
    err = library().simplex_pivot_launch(
        tabs.data_ptr(), r.data_ptr(), j.data_ptr(), mask.data_ptr(),
        B, R1, C1, _stream(dev))
    _raise_on(err, "simplex_pivot")
    pivot_update.launches += 1
    return tabs


pivot_update.launches = 0


def reduced_pivot(A, c_phase, Binv, xB, basis, use_bland, may_pivot,
                  lane_ok, *, art_cost: float, tol: float):
    """One fused revised-simplex iteration on every lane, updating
    ``Binv`` (B, R, R), ``xB`` (B, R) float64 and ``basis`` (B, R) int32
    in place on lanes where ``may_pivot & has_enter & ~unbounded``.
    ``A`` (B, R, C0) and ``c_phase`` (B, C0) are float64; the three lane
    flags (B,) bool.  Returns ``(has_enter, unbounded, degenerate)``, each
    (B,) bool — the flag half of `ref.reduced_pivot_ref`'s result."""
    if A.device.type == "cpu":
        Binv2, xB2, bas2, has_enter, unbounded, degen = reduced_pivot_ref(
            A, c_phase, Binv, xB, basis, use_bland, may_pivot, lane_ok,
            art_cost=art_cost, tol=tol)
        Binv.copy_(Binv2)
        xB.copy_(xB2)
        basis.copy_(bas2)
        return has_enter, unbounded, degen
    if A.device.type != "cuda":
        raise ValueError(f"no reduced_pivot kernel for {A.device}")
    B, R, C0 = A.shape
    dev = A.device
    _check("A", A, torch.float64, (B, R, C0), dev)
    _check("c_phase", c_phase, torch.float64, (B, C0), dev)
    _check("Binv", Binv, torch.float64, (B, R, R), dev)
    _check("xB", xB, torch.float64, (B, R), dev)
    _check("basis", basis, torch.int32, (B, R), dev)
    for name, f in (("use_bland", use_bland), ("may_pivot", may_pivot),
                    ("lane_ok", lane_ok)):
        _check(name, f, torch.bool, (B,), dev)
    flags = torch.empty((B, 3), dtype=torch.bool, device=dev)
    err = library().reduced_pivot_launch(
        A.data_ptr(), c_phase.data_ptr(), Binv.data_ptr(), xB.data_ptr(),
        basis.data_ptr(), use_bland.data_ptr(), may_pivot.data_ptr(),
        lane_ok.data_ptr(), flags.data_ptr(), B, R, C0, float(art_cost),
        float(tol), _stream(dev))
    _raise_on(err, "reduced_pivot")
    reduced_pivot.launches += 1
    return flags[:, 0], flags[:, 1], flags[:, 2]


reduced_pivot.launches = 0


def reset_launches() -> None:
    """Set both kernels' launch counters to 0."""
    pivot_update.launches = 0
    reduced_pivot.launches = 0
