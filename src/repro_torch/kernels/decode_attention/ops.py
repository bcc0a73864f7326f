"""Wrappers around the CUDA flash-decode kernel
(`csrc/decode_attention.cu`).

* `decode_attention_fwd(q, k, v, valid)` takes the Pallas function's
  layout: q (B·KH, G, D), k and v (B·KH, W, D), valid (B·KH, W) int32.
  A row without any valid slot is refused on every device (checking it
  reads ``valid``, a host sync on the card).
* `decode_attention(q, ck, cv, index, *, window)` is the model's entry:
  q (B, 1, H, D) of the token at absolute position ``index`` (a Python
  int), ck and cv (B, W, KH, D) ring caches with RoPE applied at write.
  The validity comes from `ref.ring_validity`; the token's own slot is
  always valid, so no row is empty and nothing is read back.  On the card
  the kernel reads the caches where they lie (no per-layer transpose or
  cast), so the call costs no copy of the cache.

K and V may be float32, bfloat16 or float8_e4m3fn (the last with a
bfloat16 or float32 q); they are taken in q's type, as the reference's
wrapper casts the cache: on the card the kernel widens each float8
element exactly as it loads it, so no widened copy of the ring is made.
The output is in q's type.  On a
CUDA tensor the hand-written kernel runs, built at first use with
``nvcc`` into ``build/kernels/`` of the checkout and bound with `ctypes`:
the cache is cut into `splits` of whole 64-key blocks, one CTA per
(row, split, 16 q heads).  A call is two CUDA launches (the split
partials, then their combine, one CTA per (row, q head)) and adds one to
``decode_attention_fwd.launches``.  On a CPU tensor the plain version in
`ref.py` runs and nothing is counted.  There is no fallback: a CUDA
tensor gets the kernel or an exception.

The kernel has no backward, as the reference's ``pallas_call`` has
none: with grad enabled and an input that requires it, every entry
raises on every device (`_build.refuse_grad`) rather than drop the
gradient; the model's differentiable path is its plain one.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import (Library, check_tensor, copy_width, raise_on,
                      refuse_grad, stream_of)
from .ref import decode_attention_ref, ring_validity

# the plain path (decoding is never differentiated in the model)
DECODE_PLAIN = "attn_impl='dense' (the grouped einsum over the ring)"

_DTYPES = (torch.float32, torch.bfloat16)
# the cache types the kernel reads, by its launcher's code
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
MAX_HEAD_DIM = 256
SPLIT_KEYS = 64                         # a split is whole blocks of these


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [
        P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, ctypes.c_float, I, I,
        I, P]
    lib.decode_attention_launch.restype = I


LIBRARY = Library(Path(__file__).resolve().parent / "csrc"
                  / "decode_attention.cu", _declare)


def library() -> ctypes.CDLL:
    """The kernel's shared library, built if needed and loaded once per
    process."""
    return LIBRARY.load()


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def splits(rows: int, W: int, sms: int):
    """(number of splits, keys per split) of a W-slot cache over ``rows``
    (batch, kv-head) rows: whole 64-key blocks, about one split per SM in
    all (a CTA of the partial kernel takes ~150 KB of shared memory at
    D = 256, so one fits an SM), at most one split per block."""
    blocks = -(-W // SPLIT_KEYS)
    nsplit = max(1, min(blocks, -(-sms // max(rows, 1))))
    per = -(-blocks // nsplit)
    return -(-blocks // per), per * SPLIT_KEYS


_SCRATCH = {}                           # (device index, stream) -> buffer


def _scratch(n: int, dev: torch.device, stream: int) -> torch.Tensor:
    """A float32 buffer of at least ``n`` elements for the partials of
    launches on ``stream``.  Launches on one stream run in order, so a
    call's combine has read the buffer before the next call's partials
    write it; each stream has its own."""
    buf = _SCRATCH.get((dev.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=dev)
        _SCRATCH[(dev.index, stream)] = buf
    return buf


def _launch(q, k, v, valid, valid_stride: int, kh: int, W: int):
    """Launch the kernel: q (rows, G, D); k and v rows of W keys, row r
    being kv head r % kh of batch r // kh in a (B, W, kh, D) buffer;
    valid row r at ``valid_stride * r``."""
    rows, G, D = q.shape
    dev = q.device
    stream = stream_of(dev)
    nsplit, per = splits(rows, W, sm_count(dev))
    # float32 scratch: the partials (rows, nsplit, G, D), then their
    # (m, l) pairs (rows, nsplit, G, 2)
    n_part = rows * nsplit * G * D
    scratch = _scratch(n_part + rows * nsplit * G * 2, dev, stream)
    out = torch.empty_like(q)
    err = library().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 4 * n_part,
        out.data_ptr(), rows, G, W, D, kh,
        valid_stride, nsplit, per, float(D ** -0.5),
        int(q.dtype == torch.bfloat16), KV_TYPES[k.dtype],
        copy_width(D * k.element_size(), k, v), stream)
    raise_on(err, "decode_attention_fwd")
    decode_attention_fwd.launches += 1
    return out


def _check_types(q, k, v) -> None:
    if q.dtype not in _DTYPES or k.dtype not in KV_TYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"decode_attention takes q in {_DTYPES} and k, v "
                        f"of one type in {tuple(KV_TYPES)}; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    D = q.shape[-1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be at most {MAX_HEAD_DIM}, got {D}")


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """q (B·KH, G, D); k, v (B·KH, W, D); valid (B·KH, W) int32.  Returns
    (B·KH, G, D) in q's type."""
    rows, G, D = q.shape
    refuse_grad("decode_attention_fwd", DECODE_PLAIN, q, k, v)
    if (k.dim() != 3 or k.shape[0] != rows or k.shape[2] != D
            or v.shape != k.shape or tuple(valid.shape) != tuple(k.shape[:2])):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, valid {tuple(valid.shape)} "
                         f"do not fit")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if not t.is_contiguous():        # on every device: the kernel's
            raise ValueError(f"{name} must be contiguous")   # layout
    if valid.dtype != torch.int32:
        raise TypeError(f"valid must be int32, got {valid.dtype}")
    if not bool((valid != 0).any(dim=1).all()):
        raise ValueError("decode_attention: a row has no valid slot")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention kernel for {q.device}")
    _check_types(q, k, v)
    W = k.shape[1]
    dev = q.device
    check_tensor("k", k, k.dtype, (rows, W, D), dev)
    check_tensor("v", v, k.dtype, (rows, W, D), dev)
    check_tensor("valid", valid, torch.int32, (rows, W), dev)
    return _launch(q, k, v, valid, W, 1, W)


decode_attention_fwd.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    decode_attention_fwd.launches = 0


@functools.lru_cache(maxsize=16)
def _validity(W: int, index: int, window: int, device: torch.device
              ) -> torch.Tensor:
    """`ring_validity` on ``device``, made once per (W, index, window):
    every layer of a decode step with the same ring shares it."""
    return ring_validity(W, index, window, device=device)


def grouped_rows(q: torch.Tensor, KH: int) -> torch.Tensor:
    """(B, 1, H, D) -> contiguous (B·KH, G, D), G = H // KH: row b·KH + h
    holds the q heads h·G .. h·G + G - 1 of batch b."""
    B, _, H, D = q.shape
    return q.reshape(B * KH, H // KH, D).contiguous()


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     index: int, *, window: int = 0) -> torch.Tensor:
    """q (B, 1, H, D); ck, cv (B, W, KH, D) ring caches (k roped at
    write), ``index`` the absolute position of q's token.  Returns
    (B, 1, H, D) in q's type."""
    B, one, H, D = q.shape
    W, KH = ck.shape[1], ck.shape[2]
    refuse_grad("decode_attention", DECODE_PLAIN, q, ck, cv)
    if (one != 1 or H % KH or ck.shape[0] != B or ck.shape[3] != D
            or cv.shape != ck.shape):
        raise ValueError(f"q {tuple(q.shape)} does not fit caches "
                         f"{tuple(ck.shape)}, {tuple(cv.shape)}")
    index, window = int(index), int(window)
    if index < 0 or window < 0 or W < 1:
        raise ValueError(f"index {index}, window {window}, W {W}")
    qg = grouped_rows(q, KH)
    for name, t in (("ck", ck), ("cv", cv)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = q.device
    ok = _validity(W, index, window, dev)
    if dev.type == "cpu":
        kf = ck.transpose(1, 2).reshape(B * KH, W, D)
        vf = cv.transpose(1, 2).reshape(B * KH, W, D)
        o = decode_attention_ref(qg, kf, vf, ok[None].expand(B * KH, W))
    elif dev.type == "cuda":
        _check_types(qg, ck, cv)        # shapes and layout checked above
        if ck.device != dev or cv.device != dev:
            raise ValueError(f"caches on {ck.device}, {cv.device}, "
                             f"expected {dev}")
        o = _launch(qg, ck, cv, ok, 0, KH, W)
    else:
        raise ValueError(f"no decode_attention kernel for {dev}")
    return o.view(B, 1, H, D)
