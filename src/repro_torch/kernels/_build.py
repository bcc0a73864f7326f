"""Build and load the port's CUDA kernels.

Each kernel package keeps its source under ``csrc/<name>.cu`` with a plain
C interface.  `build` compiles one source with ``nvcc`` for ``sm_90a`` into
a shared library under ``build/kernels/`` of the checkout, named by the
hash of the source and the flags (a changed source rebuilds, an unchanged
one is reused); `Library` loads it once per process with `ctypes` and lets
the kernel package declare its C signatures.  `build_many` starts one
``nvcc`` per source at once.  Nothing here runs at import: a build happens
at the first launch on a CUDA tensor, or when a caller asks for it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import torch

# <checkout>/build/kernels (this file is src/repro_torch/kernels/_build.py)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def build(src: Path) -> Tuple[Path, str]:
    """Compile ``src`` with ``NVCC_FLAGS`` into a shared library named by
    the hash of the source and the flags.  Returns ``(library path, nvcc
    and ptxas log)``; the log is empty when the library already
    existed."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{src.stem}_{digest[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)             # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


class Library:
    """One kernel source's shared library, built at first use and loaded
    once per process.  ``declare`` sets the ctypes signatures of its C
    launchers on the freshly loaded library."""

    def __init__(self, src: Path, declare: Callable[[ctypes.CDLL], None]):
        self.src = Path(src)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None

    def build(self) -> Tuple[Path, str]:
        return build(self.src)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            path, _log = self.build()
            lib = ctypes.CDLL(str(path))
            self._declare(lib)
            self._lib = lib
        return self._lib


def build_many(libs: Sequence[Library]) -> List[Tuple[Path, str]]:
    """Build every library at once (one ``nvcc`` process per source) and
    return each one's ``(path, log)`` in order; raises if any build
    failed."""
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        return list(pool.map(lambda lib: lib.build(), libs))


# ---------------------------------------------------------------------------
# what every wrapper checks before it hands pointers to a launcher
# ---------------------------------------------------------------------------
def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
                 device: torch.device) -> None:
    """Raise unless ``t`` lives on ``device`` with ``dtype`` and ``shape``
    and is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(kernel: str, plain: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a call of ``kernel``: grad is
    enabled and a tensor input requires it.  A kernel writes through
    `ctypes` into a buffer allocated beforehand, so autograd would see no
    graph and the gradient would be lost without a word; the reference's
    ``pallas_call`` has no backward either.  Checked on every device, the
    CPU (where the plain version would differentiate) included, so the
    rule is the same everywhere; ``plain`` names the path to use."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward (as the reference's pallas_call "
            f"has none) and autograd would record nothing through it; "
            f"under autograd use {plain}, or run the kernel under "
            f"torch.no_grad()")


def raise_on(err: int, kernel: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {err}")


def copy_width(row_bytes: int, *tensors: torch.Tensor) -> int:
    """Bytes of one ``cp.async`` copy (16, 8 or 4) that divide a row of
    ``row_bytes`` and every tensor's address, so that each copy is
    aligned; 0 when none does (the kernel then loads element by
    element)."""
    for width in (16, 8, 4):
        if row_bytes % width == 0 and all(t.data_ptr() % width == 0
                                          for t in tensors):
            return width
    return 0


def stream_of(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an integer handle: the raw
    handle PyTorch's own generated kernels launch on, read without building
    a `torch.cuda.Stream` object, which costs more than some launches."""
    return torch._C._cuda_getCurrentRawStream(device.index)
