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
``nvcc`` into ``build/kernels/`` of the checkout and bound with `ctypes`:
bfloat16 on the tensor cores, float32 on the FP32 cores.  The wrapper
computes the launch geometry (`launch_plan`: tiles of 64 queries, the
heaviest first under a mask; D padded for the tensor cores; the width of
one asynchronous copy).  On a CPU tensor the plain PyTorch version in
`ref.py` runs.  There is no fallback: a CUDA tensor gets the kernel or an
exception.  A call is one CUDA launch and adds one to
``flash_attention_fwd.launches``; nothing else does.

The kernel has no backward, as the reference's ``pallas_call`` has
none: with grad enabled and an input that requires it, every entry
raises on every device (`_build.refuse_grad`) rather than drop the
gradient; the model's differentiable path is its plain one.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import (Library, check_tensor, copy_width, raise_on,
                      refuse_grad, stream_of)
from .ref import MASK_KINDS, attention_ref

# the differentiable path the model takes under autograd
FLASH_PLAIN = ("attn_impl='dense' (or 'auto', which under autograd takes "
               "the reference's dense-or-chunked rule)")

_MASK_CODE = {"none": 0, "causal": 1, "window": 2}
_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
Q_TILE = 64                             # queries of one CTA
PADDED_DIMS = (32, 64, 128, 256)        # D in shared memory (bfloat16)


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd_launch.argtypes = [
        P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, I, I, I, I, I, I,
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


def launch_plan(Sq: int, D: int, mask_kind: str, group: int):
    """(q tiles, padded D, reverse, split) of a launch: ``ceil(Sq / 64)``
    tiles of 64 queries, grid row y running tile ``q_tile(y, ...)``; D
    padded with zeros to the smallest of `PADDED_DIMS` that holds it (the
    tensor cores' k-steps are 16 wide); under a causal or window mask the
    tiles go last first, so the longest start first.  ``split`` (bfloat16):
    a CTA's two warp groups take the even and the odd kv tiles of one q
    head, which halves the longest CTA of a causal launch; else they take
    two q heads of one kv head (``group`` even) and share each K and V
    tile."""
    dp = next((p for p in PADDED_DIMS if p >= D), None)
    if dp is None:
        raise ValueError(f"head_dim must be at most {MAX_HEAD_DIM}, got {D}")
    split = mask_kind == "causal" or group % 2 == 1
    return -(-Sq // Q_TILE), dp, mask_kind != "none", split


def q_tile(y: int, n_qtiles: int, reverse: bool) -> range:
    """The query rows grid row ``y`` of a launch owns (rows past Sq are
    padding the kernel never stores)."""
    tile = n_qtiles - 1 - y if reverse else y
    return range(tile * Q_TILE, (tile + 1) * Q_TILE)


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
    check_tensor("q", q, q.dtype, (BH, Sq, D), dev)
    check_tensor("k", k, q.dtype, (BKH, Sk, D), dev)
    check_tensor("v", v, q.dtype, (BKH, Sk, D), dev)
    out = torch.empty_like(q)
    n_qtiles, dp, reverse, split = launch_plan(Sq, D, mask_kind, group)
    vec = copy_width(D * q.element_size(), q, k, v)
    err = library().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq,
        Sk, D, group, _MASK_CODE[mask_kind], int(window), float(D ** -0.5),
        int(q.dtype == torch.bfloat16), n_qtiles, dp, vec, int(reverse),
        int(split), stream_of(dev))
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
