"""Wrappers around the CUDA simplex pivot kernels (`csrc/simplex_pivot.cu`).

`pivot_update` and `reduced_pivot` take the signatures `core.lp` calls
them with.  On a CUDA tensor they launch the hand-written kernel, built at
first use with ``nvcc`` into ``build/kernels/`` of the checkout and bound
with `ctypes`; on a CPU tensor they run the plain PyTorch version in
`ref.py`.  There is no fallback: a CUDA tensor gets the kernel or an
exception.

Both update their state IN PLACE (the kernels skip lanes that do not
pivot), and both wrappers keep the in-place contract on the CPU path too.
A kernel stages each lane in shared memory (`occupancy` reports the
launch): a lane larger than a block's opt-in shared memory (a tableau of
~29,000 entries, a slab of about as many) is refused, and the wrapper
raises.
Each wrapper counts its kernel launches in a plain integer attribute
(``pivot_update.launches``, ``reduced_pivot.launches``); only a kernel
launch increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library
from .._build import check_tensor as _check
from .._build import raise_on as _raise_on
from .._build import stream_of as _stream
from .ref import pivot_update_ref, reduced_pivot_ref


def _declare(lib: ctypes.CDLL) -> None:
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.simplex_pivot_launch.argtypes = [P, P, P, P, I, I, I, P]
    lib.simplex_pivot_launch.restype = I
    lib.reduced_pivot_launch.argtypes = [P, P, P, P, P, P, P, P, P,
                                         I, I, I, D, D, P]
    lib.reduced_pivot_launch.restype = I
    for name in ("simplex_pivot_occupancy", "reduced_pivot_occupancy"):
        getattr(lib, name).argtypes = [I, I, P, P, P]
        getattr(lib, name).restype = I
    lib.reduced_pivot_instance.argtypes = [I, I]
    lib.reduced_pivot_instance.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" /
                  "simplex_pivot.cu", _declare)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


def occupancy(kernel: str, rows: int, cols: int) -> dict:
    """The launch of ``kernel`` ("simplex_pivot" for (rows, cols)
    tableaus, "reduced_pivot" for (rows, cols) column slabs) on the
    current device: lanes (warps) per CTA, the CTA's shared memory in bytes
    and CTAs per SM (the occupancy calculator)."""
    warps, ctas = ctypes.c_int(0), ctypes.c_int(0)
    smem = ctypes.c_longlong(0)
    _raise_on(getattr(library(), f"{kernel}_occupancy")(
        rows, cols, ctypes.byref(warps), ctypes.byref(smem),
        ctypes.byref(ctas)), f"{kernel}_occupancy")
    return dict(warps=warps.value, smem=smem.value, ctas_per_sm=ctas.value)


def reduced_instance(rows: int, cols: int) -> int:
    """The job count J of the `reduced_pivot` instance compiled for
    (rows, cols) slabs, the LP of J jobs on two local models (rows J + 2,
    cols 3J + 2, J <= 16); 0 where the slab takes the generic instance."""
    return library().reduced_pivot_instance(rows, cols)


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
