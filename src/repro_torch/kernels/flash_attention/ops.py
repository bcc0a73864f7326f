"""Wrappers around the CUDA flash attention kernels
(`csrc/flash_attention.cu`).

* `flash_attention_fwd(q, k, v, *, mask_kind, window, group)` takes the
  Pallas function's layout: q (B·KH·G, Sq, D), k and v (B·KH, Sk, D).
* `flash_attention(q, k, v, q_pos, k_pos, *, mask_kind, window)` is the
  model layer's entry: q (B, Sq, H, D), k and v (B, Sk, KH, D) with KV
  not repeated (group = H // KH).

Masks are derived from indices, exactly as in the reference's
`ops.flash_attention`: the kernel assumes self-attention positions
``arange(Sq)`` and ``arange(Sk)``, and ``q_pos`` / ``k_pos`` only have to
match those lengths.  Inputs where some query row would have no live key
(a window with Sq >= Sk + window) are refused on every device.

On a CUDA tensor a hand-written kernel runs, built at first use with
``nvcc`` into ``build/kernels/`` of the checkout and bound with `ctypes`.
bfloat16 runs on Hopper's tensor cores in FlashAttention-3's shape: a
producer warp group brings Q once and K and V tile by tile by TMA into a
ring of `mbarrier`-guarded stages, and two consumer warp groups of 64
query rows each run ``wgmma`` (tiles of 128 queries x 128 keys, 80 keys
at D 256; one consumer and 64 queries where Sq <= 64), one persistent CTA
an SM walking its share of the (q tile, head) work.  float32 runs on the
FP32 cores in tiles of 64 queries.  The wrapper computes the launch
geometry (`launch_plan`): the q tiles (the heaviest first under a mask),
the head dim the kernel's tiles hold (64, 80, 128 or 256) and the width
q, k and v are read at.  The TMA takes rows of a multiple of 16 bytes,
so for a bfloat16 D that is no multiple of 8 (D 20 and 100 in the card
tests; no model has one) the wrapper zero-pads q, k and v to the next
multiple of 8 (`pad_width`), passes the scale of the true D (the zero
columns add nothing to q.k), and the kernel writes the output's true D
columns only.  On a CPU tensor the plain PyTorch version in `ref.py`
runs.  There is no fallback: a CUDA tensor gets the kernel or an
exception (a refused launch, a tensor map that cannot be encoded, a
failed build).  A call is one launch of the flash kernel and adds one to
``flash_attention_fwd.launches``; nothing else does.

The kernel has no backward, as the reference's ``pallas_call`` has
none: with grad enabled and an input that requires it, every entry
raises on every device (`_build.refuse_grad`) rather than drop the
gradient; the model's differentiable path is its plain one.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from .._build import Library, raise_on, refuse_grad, stream_of
from .ref import MASK_KINDS, attention_ref

# the differentiable path the model takes under autograd
FLASH_PLAIN = ("attn_impl='dense' (or 'auto', which under autograd takes "
               "the reference's dense-or-chunked rule)")

_MASK_CODE = {"none": 0, "causal": 1, "window": 2}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
KERNEL_DIMS = (64, 80, 128, 256)        # head dims of the bf16 kernel's tiles
CONSUMER_ROWS = 64                      # queries of one consumer warp group
SIMT_Q_TILE = 64                        # queries of a float32 CTA
# the launcher's code for a tensor map the driver refuses (+ its CUresult)
ENCODE_FAILED = 10000


class Plan(NamedTuple):
    """The geometry of one launch."""
    n_qtiles: int       # q tiles of a head
    q_rows: int         # queries of a q tile
    width: int          # D of q, k and v as the kernel reads them
    instance: int       # head dim of the kernel's tiles (bf16); D (float32)
    kv_tile: int        # keys of a kv tile
    consumers: int      # consumer warp groups (bf16); 0 (float32)
    reverse: bool       # q tiles launched last first


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd_launch.argtypes = [
        P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_float, I, I, I, I, I,
        P]
    lib.flash_attention_fwd_launch.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc"
                  / "flash_attention.cu", _declare)


def library() -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


def _check_mask(mask_kind: str, window: int, Sq: int, Sk: int) -> None:
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"mask_kind must be one of {MASK_KINDS}, "
                         f"got {mask_kind!r}")
    if Sk < 1:
        raise ValueError("attention needs at least one key")
    if mask_kind == "window" and (window < 1 or Sq >= Sk + window):
        raise ValueError(
            f"window {window} with Sq {Sq}, Sk {Sk} leaves query rows with "
            f"no live key")


@functools.lru_cache(maxsize=256)
def launch_plan(Sq: int, D: int, mask_kind: str, bf16: bool = True) -> Plan:
    """The launch's geometry.  bfloat16: q tiles of 128 queries (two
    consumer warp groups), or of 64 (one) where Sq <= 64; rows read at D
    rounded up to a multiple of 8 (the TMA's 16 bytes); tiles holding the
    smallest of `KERNEL_DIMS` at least that wide; kv tiles of 128 keys, 80
    at D 256 (where the O accumulator takes 128 registers a thread).
    float32: q tiles of 64 queries, 32-key blocks.  Under a causal or
    window mask the q tiles go last first, so the longest start first."""
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be at most {MAX_HEAD_DIM}, got {D}")
    reverse = mask_kind != "none"
    if not bf16:
        return Plan(-(-Sq // SIMT_Q_TILE), SIMT_Q_TILE, D, D, 32, 0, reverse)
    width = -(-D // 8) * 8
    instance = next(d for d in KERNEL_DIMS if d >= width)
    consumers = 1 if Sq <= CONSUMER_ROWS else 2
    rows = CONSUMER_ROWS * consumers
    return Plan(-(-Sq // rows), rows, width, instance,
                80 if instance == 256 else 128, consumers, reverse)


def q_tile(y: int, plan: Plan) -> range:
    """The query rows of the ``y``-th q tile in the kernel's order of work,
    the longest first under a mask (rows past Sq are padding the kernel
    never stores)."""
    tile = plan.n_qtiles - 1 - y if plan.reverse else y
    return range(tile * plan.q_rows, (tile + 1) * plan.q_rows)


def kv_tiles(rows: range, Sq: int, Sk: int, mask_kind: str, window: int,
             kv_tile: int) -> range:
    """The first keys of the kv tiles a q tile of ``rows`` visits, as the
    kernel walks them: the band its live rows can see (causal: up to its
    last query; window: from the tile holding its first query's first
    key)."""
    q_last = min(rows[-1], Sq - 1)
    begin = (max(0, rows[0] - window + 1) // kv_tile * kv_tile
             if mask_kind == "window" else 0)
    end = Sk if mask_kind == "none" else min(Sk, q_last + 1)
    return range(begin, end, kv_tile)


def pad_width(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with its last dim zero-padded to ``width`` (``x`` itself when
    it is that wide already)."""
    D = x.shape[-1]
    if width == D:
        return x
    return torch.nn.functional.pad(x, (0, width - D))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it where its address is not 16-byte aligned
    (the TMA's rule)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mask_kind: str = "causal", window: int = 0,
                        group: int = 1) -> torch.Tensor:
    """q (B·KH·G, Sq, D); k, v (B·KH, Sk, D), G = ``group``; q-head row b
    reads kv head b // group.  Returns (B·KH·G, Sq, D) in q's dtype."""
    BH, Sq, D = q.shape
    BKH, Sk, Dk = k.shape
    if group < 1 or BH != BKH * group or Dk != D or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit group {group}")
    _check_mask(mask_kind, window, Sq, Sk)
    refuse_grad("flash_attention_fwd", FLASH_PLAIN, q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():        # on every device: the kernel's
            raise ValueError(f"{name} must be contiguous")   # layout
    if q.device.type == "cpu":
        return attention_ref(q, k, v, mask_kind=mask_kind, window=window,
                             group=group)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes {_DTYPES}, got {q.dtype}")
    if D % 4 or D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}, got {D}")
    dev = q.device
    for name, t in (("k", k), ("v", v)):  # shapes and layout checked above
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
    out = torch.empty_like(q)
    bf16 = q.dtype == torch.bfloat16
    plan = launch_plan(Sq, D, mask_kind, bf16)
    if bf16 and (plan.width != D or (q.data_ptr() | k.data_ptr()
                                      | v.data_ptr()) % 16):
        q, k, v = (_aligned(pad_width(t, plan.width)) for t in (q, k, v))
    err = library().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq,
        Sk, plan.width, D, group, _MASK_CODE[mask_kind], int(window),
        float(D ** -0.5), int(bf16), plan.n_qtiles, plan.instance,
        plan.consumers, int(plan.reverse), stream_of(dev))
    if err >= ENCODE_FAILED:
        raise RuntimeError(f"flash_attention_fwd: cuTensorMapEncodeTiled "
                           f"failed with CUresult {err - ENCODE_FAILED}")
    raise_on(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    mask_kind: str, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KH, D) with KH dividing H.  Returns
    (B, Sq, H, D).  Self-attention positions (``arange``) are assumed:
    the mask comes from indices, ``q_pos`` / ``k_pos`` give the lengths."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if H % KH or len(q_pos) != Sq or len(k_pos) != Sk:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"{len(q_pos)} and {len(k_pos)} positions")
    o = flash_attention_fwd(heads_major(q), heads_major(k), heads_major(v),
                            mask_kind=mask_kind, window=window,
                            group=H // KH)
    return o.view(B, H, Sq, D).transpose(1, 2)


def heads_major(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous (B·H, S, D), the kernel's layout."""
    B, S, H, D = x.shape
    return x.transpose(1, 2).contiguous().view(B * H, S, D)
