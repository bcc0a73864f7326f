"""Wrapper around the CUDA RG-LRU recurrence kernel (`csrc/rglru_scan.cu`).

`rglru_scan_fwd(a, b)` takes the Pallas function's layout: a and b
(B, S, W) float32, contiguous; it returns the hidden sequence h (B, S, W)
float32 with ``h_t = a_t h_{t-1} + b_t`` and ``h_{-1} = 0``.
`rglru_scan(a, b)` is the reference wrapper's name for the same call.
Shapes, type and contiguity are checked on every device.

On a CUDA tensor the hand-written kernel runs, built at first use with
``nvcc`` into ``build/kernels/`` of the checkout and bound with `ctypes`,
in the launch geometry `launch_geometry` picks from the shape; on a CPU
tensor the plain log-step scan in `ref.py` runs; any other device raises.
There is no fallback: a CUDA tensor gets the kernel or an exception.  Only
a kernel launch adds one to ``rglru_scan_fwd.launches``.

The kernel has no backward, as the reference's ``pallas_call`` has
none: with grad enabled and an input that requires it, every entry
raises on every device (`_build.refuse_grad`) rather than drop the
gradient; the model's differentiable path is its plain one.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from .._build import Library, check_tensor, raise_on, refuse_grad, stream_of
from .ref import rglru_scan_ref

# the differentiable path the model takes under autograd
RGLRU_PLAIN = "impl='jnp' (the plain log-step scan, ref.rglru_scan_ref)"

THREADS = 256                           # threads of a CTA
N_SM = 132                              # SMs of an H100 SXM
MAX_SMEM = 232448                       # opt-in shared memory of a CTA
# every compiled (C, L, stages), as `RGLRU_INSTANCES` in csrc/rglru_scan.cu
INSTANCES = ((32, 64, 2), (32, 64, 3), (32, 64, 4),
             (32, 128, 2), (32, 128, 3), (32, 128, 4),
             (32, 256, 2), (32, 256, 3),
             (16, 128, 3), (16, 128, 4), (16, 256, 3), (16, 256, 4),
             (16, 256, 6), (16, 512, 3),
             (8, 128, 3), (8, 128, 4), (8, 256, 3), (8, 256, 4), (8, 256, 6),
             (8, 512, 3), (8, 512, 4))
# the (L, stages) of each channel group C, from `chip_smoke.py`'s sweep of
# every instance: C 32 the fastest at recurrentgemma-9b's forward, C 16 and
# 8 at the ragged shape; a C 32 call of under 1.5 CTAs an SM (one prompt of
# 4096 channels) takes `FEW_CTAS_STAGES` instead, more bytes in flight a CTA
TILES = {32: (64, 2), 16: (256, 4), 8: (512, 4)}
FEW_CTAS_STAGES = 4


class Geometry(NamedTuple):
    """One launch of the kernel: CTAs of ``channels`` (C) channels of one
    batch row walk the sequence in tiles of ``steps`` (L) steps, each split
    into ``split`` sub-chunks (one a thread), through a ring of ``stages``
    tiles in ``smem`` bytes of shared memory; ``ctas`` = B ceil(W / C)."""
    channels: int
    steps: int
    split: int
    stages: int
    ctas: int
    smem: int


def geometry_of(B: int, W: int, C: int, L: int, stages: int) -> Geometry:
    """The launch of instance (C, L, stages) on (B, ., W); its shared
    memory is counted as the kernel lays it out (`Tile` in the source)."""
    if (C, L, stages) not in INSTANCES:
        raise ValueError(f"no compiled rglru_scan instance {(C, L, stages)}")
    split = THREADS // C
    sub_stride = L // split * C + (C if C < 32 else 0)
    floats = stages * 2 * split * sub_stride + 2 * split * C
    return Geometry(C, L, split, stages, B * -(-W // C), 4 * floats)


def launch_geometry(B: int, S: int, W: int) -> Geometry:
    """The kernel's geometry for a (B, S, W) call: the widest channel group
    (32, 16, 8) with a CTA on at least half of the card's SMs, else 8; the
    group's tile and ring from `TILES`.  A pure function of the shape (S
    does not move it: steps past S are zero-filled copies that read
    nothing)."""
    C = next((c for c in (32, 16) if B * -(-W // c) >= N_SM // 2), 8)
    L, stages = TILES[C]
    if C == 32 and B * -(-W // C) < 3 * N_SM // 2:
        stages = FEW_CTAS_STAGES
    return geometry_of(B, W, C, L, stages)


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_fwd_launch.argtypes = [P, P, P, I, I, I, I, I, I, P]
    lib.rglru_scan_fwd_launch.restype = I
    lib.rglru_scan_occupancy.argtypes = [I, I, I, P, P]
    lib.rglru_scan_occupancy.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu",
                  _declare)


def library() -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


def occupancy(g: Geometry) -> dict:
    """The dynamic shared memory and CTAs per SM of ``g``'s instance on the
    current device (the CUDA occupancy calculator)."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    if not library().rglru_scan_occupancy(g.channels, g.steps, g.stages,
                                          ctypes.byref(smem),
                                          ctypes.byref(blocks)):
        raise ValueError(f"no compiled rglru_scan instance {g}")
    return dict(smem=smem.value, ctas_per_sm=blocks.value)


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor, *,
                   geometry: Optional[Geometry] = None) -> torch.Tensor:
    """a, b (B, S, W) float32 -> h (B, S, W) float32.  ``geometry`` (on a
    CUDA tensor) replaces `launch_geometry`'s, to time another instance."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"be one (B, S, W) shape")
    refuse_grad("rglru_scan_fwd", RGLRU_PLAIN, a, b)
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
    g = geometry or launch_geometry(Bb, S, W)
    err = library().rglru_scan_fwd_launch(a.data_ptr(), b.data_ptr(),
                                          h.data_ptr(), Bb, S, W, g.channels,
                                          g.steps, g.stages,
                                          stream_of(a.device))
    raise_on(err, "rglru_scan_fwd")
    rglru_scan_fwd.launches += 1
    return h


rglru_scan_fwd.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    rglru_scan_fwd.launches = 0


rglru_scan = rglru_scan_fwd             # the reference wrapper's name
