"""Wrappers around the CUDA CCKP kernel (`csrc/cckp_dp.cu`).

* `models_dp(y, p, a, n_steps)` runs the m model groups of one AMDP call
  over a batch of value grids, each lane with its own integerized times
  ``p[b]`` and accuracies ``a[b]``: one kernel launch.
* `model_dp(y, p, a, n_steps)` runs one model group: the same kernel with
  m = 1.

On a CUDA tensor they launch the hand-written kernel, built at first use
with ``nvcc`` into ``build/kernels/`` of the checkout and bound with
`ctypes`, in the instance `plan` names for the shape and the card: the
many-lane one (persistent CTAs, a lane's grids in shared memory, the next
lane loaded by bulk copies) or the split one (units of (model, lane, tile)
over the whole card, the grids in device memory).  On a CPU tensor they
run the plain PyTorch versions in `ref.py`.  There is no fallback: a CUDA
tensor gets the kernel or an exception.  Only a kernel launch adds one to
``models_dp.launches``, whichever entry launched it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

from .._build import Library, check_tensor, raise_on, stream_of
from .ref import cckp_model_dp_ref, cckp_models_dp_ref

INSTANCES = ("lanes", "split")      # the source's Instance, in its order
WARPS = 8                           # warps of a split CTA (kWarps)
LANE_WARPS = 16                     # walking warps, many-lane (kLaneWarps)
BUFFERS = 3                         # grids of the many-lane instance
SPLIT_ROWS = (4, 2, 1)              # rows a warp of the split instance holds
SPLIT_FILL = 32                     # a model's units per SM, at least
MAX_FIXED_K = 16                    # K1 compiled into a walk (kMaxFixedK)
LANE_ALONE_CELLS = 8192             # a lone lane one SM walks fastest


class Plan(NamedTuple):
    """How one call runs: ``instance`` ("lanes" or "split"), the dynamic
    shared memory of a CTA (``smem``), the rows a warp of the split
    instance holds (``rows``; 0 in the other) and the work units the
    persistent CTAs share (``units``: lanes, or (model, lane, tile)
    units)."""
    instance: str
    smem: int
    rows: int
    units: int


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cckp_models_dp_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, I,
                                          I, I, I, I, P]
    lib.cckp_models_dp_launch.restype = I
    lib.cckp_dp_smem_bytes.argtypes = [I, I, I]
    lib.cckp_dp_smem_bytes.restype = ctypes.c_longlong
    lib.cckp_dp_max_shared.argtypes = [P]
    lib.cckp_dp_max_shared.restype = I
    lib.cckp_dp_occupancy.argtypes = [I, I, I, I, P]
    lib.cckp_dp_occupancy.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc" / "cckp_dp.cu",
                  _declare)
# per device: (opt-in shared memory of a block, SMs); plans and CTAs by
# (device, B, T1, K1, m)
_CARD: Dict[int, Tuple[int, int]] = {}
_PLANS: Dict[Tuple[int, int, int, int, int], Tuple[Plan, int]] = {}


def library() -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


def buffer_bytes(T1: int, K1: int) -> int:
    """Bytes of one grid buffer of the many-lane instance: a lane's cells
    and the up to 12 bytes before them that align its bulk copy, rounded
    up to 16."""
    return (T1 * K1 * 4 + 12 + 15) // 16 * 16


def smem_bytes(instance: str, T1: int, K1: int) -> int:
    """Dynamic shared memory of one CTA of ``instance`` for a (T1, K1)
    grid: the many-lane instance's three buffers, each warp's stage of 32
    rows of counts, four mbarriers and three lane tickets; none in the
    split instance."""
    if instance == "split":
        return 0
    return (BUFFERS * buffer_bytes(T1, K1) + LANE_WARPS * 32 * K1 * 4
            + 4 * 8 + 16)


def plan(B: int, T1: int, K1: int, m: int, sms: int,
         max_smem: int) -> Plan:
    """The instance of a call on ``B`` lanes of (T1, K1) grids with ``m``
    models, on a card of ``sms`` SMs whose blocks may take ``max_smem``
    bytes of shared memory: the many-lane instance when its buffers fit
    and there are two lanes or more, or one small lane (at most
    `LANE_ALONE_CELLS` cells, its K1 compiled); else the split one, its
    warps holding the most rows (`SPLIT_ROWS`) that still give every SM
    `SPLIT_FILL` units of a model.  On an H100 the many-lane instance
    took 17-20 µs from 4 to 131 lanes of 1201 x 13, the split one 17-169;
    one lane of 1201 x 13 took 15.5 and 13.1, of 326 x 9 6.9 and 10.6
    (`PERF.md` §6)."""
    lanes = smem_bytes("lanes", T1, K1)
    alone = T1 * K1 <= LANE_ALONE_CELLS and K1 <= MAX_FIXED_K
    if lanes <= max_smem and (B >= 2 or alone):
        return Plan("lanes", lanes, 0, B)
    col_blocks = -(-K1 // 32)
    for rows in SPLIT_ROWS:
        tiles = -(-T1 // (WARPS * rows)) * col_blocks
        if B * tiles >= SPLIT_FILL * sms:
            break
    return Plan("split", 0, rows, max(m, 1) * B * tiles)


def _card(index: int) -> Tuple[int, int]:
    """(a block's opt-in shared memory, SMs) of device ``index``."""
    if index not in _CARD:
        smem = ctypes.c_int(0)
        with torch.cuda.device(index):
            raise_on(library().cckp_dp_max_shared(ctypes.byref(smem)),
                     "cckp_dp_max_shared")
        _CARD[index] = (smem.value, torch.cuda.get_device_properties(
            index).multi_processor_count)
    return _CARD[index]


def occupancy(instance: str, T1: int, K1: int, rows: int = 0) -> int:
    """CTAs of ``instance`` that fit an SM of the current device for a
    (T1, K1) grid (the CUDA occupancy calculator)."""
    out = ctypes.c_int(0)
    raise_on(library().cckp_dp_occupancy(INSTANCES.index(instance), T1, K1,
                                         rows, ctypes.byref(out)),
             "cckp_dp_occupancy")
    return out.value


def card_plan(B: int, T1: int, K1: int, m: int,
              device: torch.device) -> Tuple[Plan, int]:
    """`plan` on ``device`` and its persistent CTAs: the units, at most as
    many as fit the card at once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (index, B, T1, K1, m)
    if key not in _PLANS:
        max_smem, sms = _card(index)
        pl = plan(B, T1, K1, m, sms, max_smem)
        with torch.cuda.device(index):
            per_sm = occupancy(pl.instance, T1, K1, pl.rows)
        if per_sm < 1:
            raise ValueError(f"no CTA of the {pl.instance} instance fits "
                             f"an SM for a {T1} x {K1} grid")
        ctas = min(pl.units, sms * per_sm)
        if pl.units + ctas >= 2 ** 31:
            raise ValueError(f"{pl.units} units overflow the kernel's "
                             f"ticket")
        _PLANS[key] = (pl, ctas)
    return _PLANS[key]


def models_dp(y: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
              n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The m CCKP model groups of one AMDP call on every lane, model after
    model: ``y`` (B, T1, K1) float32, ``p`` (B, m) int32 >= 0, ``a`` (B,
    m) float32.  Returns new tensors ``(y_final (B, T1, K1) float32,
    bestq (m, B, T1, K1) int32)``, ``bestq[i]`` the argmax table of model
    i (see `ref.py`).  On the card ``models_dp.last_plan`` holds the plan
    of the last launch."""
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
    if y.data_ptr() % 16:
        y = y.clone()            # the kernel's bulk copies want 16 bytes
    pl, ctas = card_plan(B, T1, K1, m, dev)
    out = torch.empty_like(y)
    bestq = torch.empty((m, B, T1, K1), dtype=torch.int32, device=dev)
    split = pl.instance == "split"
    scratch = torch.empty_like(y) if split and m >= 2 else None
    sync = torch.empty((1 + B * m if split else 1,), dtype=torch.int32,
                       device=dev)
    err = library().cckp_models_dp_launch(
        y.data_ptr(), p.data_ptr(), a.data_ptr(), out.data_ptr(),
        bestq.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        sync.data_ptr(), B, T1, K1, m, int(n_steps),
        INSTANCES.index(pl.instance), pl.rows, ctas, stream_of(dev))
    raise_on(err, "cckp_model_dp")
    models_dp.launches += 1
    models_dp.last_plan = pl
    return out, bestq


models_dp.launches = 0
models_dp.last_plan = None


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
