"""Layers of the LM: the port of `repro.models.layers` — attention
(causal, sliding-window, local, the encoder's unmasked self-attention and
the decoder's cross-attention), the SwiGLU, GELU and MoE FFNs, the SSD
and RG-LRU mixers and the KV cache (forward, prefill and one-token
decode).

Numerics follow the reference: parameters live in ``param_dtype``
(float32) and are cast to the compute ``dtype`` (bfloat16 by default) at
each use; norms accumulate in float32, attention scores and softmax run in
float32, the SSD scan, the RG-LRU gates and recurrence and their states
in float32.

Attention (`attention`, and `attn_decode` on the KV cache) has two
implementations, chosen by ``cfg.attn_impl``:

  * ``"auto"``, ``"chunked"``, ``"pallas"`` — without autograd, the
    hand-written kernels:
    flash attention (`kernels.flash_attention`) over a sequence and
    flash-decode (`kernels.decode_attention`) over a ring cache, each its
    plain PyTorch version on a CPU tensor.  KV is passed un-repeated with
    group = H // KH; the reference repeats KV in `attention` and groups
    the einsum in `attn_decode`, and all give q-head h the kv-head h // G.
  * ``"dense"`` — the reference's dense paths (`_dense_attention`, and the
    grouped einsum of `attn_decode`): plain PyTorch, used to compare.

The SSD mixer (`ssd_apply`) takes ``impl``: ``"pallas"`` runs the SSD
scan kernel (`kernels.ssd_scan`; its plain version on a CPU tensor),
``"jnp"`` the chunked plain path (`ssd_scan_chunked`).  The RG-LRU mixer
(`rglru_apply`) takes ``impl`` the same way: ``"pallas"`` runs the
recurrence kernel (`kernels.rglru_scan`; its plain version on a CPU
tensor), ``"jnp"`` the plain log-step scan (`rglru_scan_ref`); the
reference inlines its scan (`jax.lax.associative_scan`) and reaches its
Pallas kernel only through `kernels/rglru_scan/ops.py`.  One-token decode
(`ssd_decode`, `rglru_decode`) is a plain state update in both packages.

Block functions return ``(x, cache)`` as the reference's do; the cache is
None unless ``want_cache`` (prefill).  The one-token decode functions
write the new K/V row into the ring cache in place (PyTorch's idiom; the
reference rewrites the whole ring with a one-hot select only for the
TPU's SPMD partitioner) and return the cache dict with the new SSD or
RG-LRU state.

Under autograd (grad enabled and q, k or v requiring it) the kernels,
which have no backward, are not reached: `attention` takes the
reference's own rule for ``"auto"`` — dense when Sq·Sk <= 2048², else the
online-softmax scan over KV chunks (`_chunked_attention`, each chunk
step checkpointed; `_qblock_attention` with ``cfg.q_block``) — and
``"chunked"`` is that plain chunked path, as in the reference;
``"pallas"`` raises, as does ``impl="pallas"`` of the SSD and RG-LRU
mixers and every impl of `attn_decode` but ``"dense"`` (the kernel
entries refuse a graph on every device).  On ``meta`` tensors (the dry
run, where nothing runs) ``"auto"`` and ``"chunked"`` take the same
plain paths, whose ops give the shapes and the counts; ``"pallas"``
raises there.  The rule depends on the grad mode and the device type
alone, never on a kernel failing.  The backward dtype barrier
(`grad_dtype_barrier`) sits where the reference puts it, on q, k and v.

The reference's sharding constraints
(`distributed.sharding.shard_activation`) sit at its call sites too — q,
k and v on the heads, a chunk's scores, a MoE dispatch's token groups:
each redistributes a DTensor under a sharding context and returns a
plain tensor untouched.  A kernel given DTensors runs on each rank's own
rows (`sharding.on_local_rows`: the inputs split along the batch alone,
each rank's shard handed to the kernel as a plain tensor; every kernel
computes each batch row on its own), so a sharded program launches the
same kernels as an unsharded one.  Parameter definitions map names to
(shape, logical axes), the axes naming each dim for the sharding rules.

A "dec" layer given ``enc_out`` adds cross-attention after its
self-attention: q from the decoder, K and V from ``enc_out``, no mask and
no RoPE (`_cross_attend`); in decode the cross K and V are recomputed
from ``enc_out`` every step, as the reference does.  The MoE FFN
(`moe_apply`) routes each token to its top-k experts in
`jax.lax.top_k`'s order (`top_k`) and, over more than one position,
dispatches into capacity-bounded expert buffers, dropping overflow as the
reference does; its expert products are batched matrix products (plain
einsums in the reference too).  A float8_e4m3fn KV cache is written
through `cast_kv`, which rounds as the reference's cast does (NaN past
the format's range, where `Tensor.to` saturates).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (batch_split_only, evened,
                                   grad_batch_split_only, merged,
                                   on_local_rows, replicated,
                                   shard_activation, split_ready, whole)
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.decode_attention.ref import ring_validity
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.rglru_scan.ops import rglru_scan
from ..kernels.rglru_scan.ref import rglru_scan_ref
from ..kernels.ssd_scan.ops import ssd_scan
from ..kernels.ssd_scan.ref import ssd_chunked_ref
from .config import ModelConfig

NEG_INF = -1e30
FLASH_IMPLS = ("auto", "chunked", "pallas")
SCAN_IMPLS = ("pallas", "jnp")
FP8 = torch.float8_e4m3fn
# |x| above this rounds past float8_e4m3fn's largest finite value, 448
# (464 itself ties to even, down to 448)
FP8_OVERFLOW = 464.0


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string ("bfloat16", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a function of ``tensors``: grad enabled and
    one of them requiring it."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def on_meta(*tensors: torch.Tensor) -> bool:
    """Whether an input lives on the ``meta`` device (the dry run's
    shards): no kernel runs there, so ``"auto"`` attention takes its
    plain path, whose ops carry the shapes and the counts."""
    return any(t.device.type == "meta" for t in tensors)


def checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant) when autograd records it —
    the reference's `jax.checkpoint` — else a plain call."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class _GradBf16(torch.autograd.Function):
    """Identity forward; the cotangent cast to bfloat16 on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def grad_dtype_barrier(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; casts the cotangent to bfloat16 on the way back
    (the reference's `layers.grad_dtype_barrier`, a `jax.custom_vjp`).

    JAX promotes a cotangent by its einsums' rules, so a float32
    accumulator upstream makes a bfloat16 activation's gradient float32;
    the reference pins it back at each block boundary and on q, k and v.
    PyTorch already gives a tensor's gradient that tensor's dtype, so for
    the port the cast is a no-op: it is kept where the reference places
    it so that the backward's dtypes stay pinned if an op upstream ever
    promotes.  A float32 tensor, or one autograd does not record, passes
    through untouched."""
    if x.dtype == torch.bfloat16 and wants_grad(x):
        return _GradBf16.apply(x)
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """Squares in the compute dtype, their mean in float32, as the
    reference does."""
    dt = x.dtype
    var = torch.square(x).float().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dt)
    return x * inv * (1.0 + scale.to(dt))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, D) rotated at ``positions`` (broadcastable to
    (..., S)); angles in float32, the rotation in x's dtype."""
    half = x.shape[-1] // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = positions[..., None].float() * freq                # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cast_kv(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to the KV cache's ``dtype``, bit for bit the reference's
    ``astype``.  For float8_e4m3fn that is round to nearest even in range
    and NaN (sign kept) where |x| > 464, infinities included: XLA's
    convert overflows to NaN where `Tensor.to` saturates to ±448."""
    y = x.to(dtype)
    if dtype != FP8:
        return y
    over = x.float().abs() > FP8_OVERFLOW
    nan = torch.signbit(x).to(torch.uint8) * 128 + 127     # 0x7f / 0xff
    return torch.where(over, nan, y.view(torch.uint8)).view(FP8)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as its bytes (indexed writes go through these),
    any other as itself."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def zeros_of(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """Zeros of ``dtype``; float8 ones as zero bytes (+0.0)."""
    if dtype == FP8:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(FP8)
    return torch.zeros(shape, dtype=dtype, device=device)


def _zero_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` zero rows shaped like ``x``'s along dim 1 (F.pad's zeros; a
    DTensor's keep its other splits: DTensor has no strategy for `pad` in
    torch 2.11)."""
    return torch.zeros_like(x[:, :1]).expand(
        (x.shape[0], n) + tuple(x.shape[2:]))


def _mask(kind: str, q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: int) -> torch.Tensor:
    """(Sq, Sk) boolean mask from absolute positions."""
    q = q_pos[:, None]
    k = k_pos[None, :]
    if kind == "causal":
        return k <= q
    if kind == "window":                  # causal sliding window
        return (k <= q) & (k > q - window)
    if kind == "none":
        return torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                          device=q_pos.device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _dense_attention(q, k, v, q_pos, k_pos, mask_kind, window):
    """q, k, v: (B, S, H, D) — KV already repeated to H heads."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = _mask(mask_kind, q_pos, k_pos, window)
    s = torch.where(m[None, None], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _chunked_attention(q, k, v, q_pos, k_pos, mask_kind, window, chunk,
                       score_dtype=torch.float32):
    """Online-softmax scan over KV chunks (the reference's
    `_chunked_attention`), shapes as in `_dense_attention`.  Scores are
    emitted in ``score_dtype`` (float32, or bfloat16 to trade mantissa
    bits for bfloat16 cotangents, as the reference's knob) and the softmax
    accumulators kept in float32; each chunk's step is checkpointed, so
    the backward never holds every chunk's (Sq, chunk) score block.  KV
    is padded to whole chunks; unlike the reference, which gives padded
    keys the position -10^9 (live under a causal or no mask), the padded
    keys are masked, so the result equals the dense path on any length.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    nchunk = -(-Sk // chunk)
    pad = nchunk * chunk - Sk
    live = torch.ones(nchunk * chunk, dtype=torch.bool, device=q.device)
    if pad:
        k = torch.cat([k, _zero_rows(k, pad)], dim=1)
        v = torch.cat([v, _zero_rows(v, pad)], dim=1)
        k_pos = F.pad(k_pos, (0, pad))
        live[Sk:] = False
    scale = D ** -0.5
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)

    def step(acc, mx, den, kb, vb, pb, lb):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float())
        s = s.to(score_dtype).float() * scale
        s = batch_split_only(shard_activation(s, "batch", "act_heads",
                                              None, None))
        m = _mask(mask_kind, q_pos, pb, window) & lb[None]
        s = torch.where(m[None, None], s, neg)
        bmx = torch.maximum(mx, s.amax(dim=-1))
        corr = torch.exp(mx - bmx)
        p = torch.exp(s - bmx[..., None])
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vb.dtype), vb).float()
        den = den * corr + p.sum(dim=-1)
        return acc, bmx, den

    # *_like of q: a DTensor q gives them its split (a factory's would be
    # whole at the global shape on every rank)
    qt = q.transpose(1, 2)
    acc = torch.zeros_like(qt, dtype=torch.float32)
    mx = torch.full_like(qt[..., 0], NEG_INF, dtype=torch.float32)
    den = torch.zeros_like(qt[..., 0], dtype=torch.float32)
    for c in range(nchunk):
        cut = slice(c * chunk, (c + 1) * chunk)
        acc, mx, den = checkpointed(step, acc, mx, den, k[:, cut],
                                    v[:, cut], k_pos[cut], live[cut])
    o = acc / torch.clamp(den[..., None], min=1e-30)
    return o.transpose(1, 2).to(q.dtype)                  # (B, Sq, H, D)


def _qblock_attention(q, k, v, q_pos, k_pos, mask_kind, window,
                      cfg: ModelConfig):
    """Causal or windowed attention with static per-q-block KV ranges (the
    reference's `_qblock_attention`): query block i of ``cfg.q_block``
    rows scans only the KV prefix (causal) or its window band, each with
    `_chunked_attention`."""
    Sq = q.shape[1]
    qb = cfg.q_block
    outs = []
    for i in range(Sq // qb):
        qs, qe = i * qb, (i + 1) * qb
        ks = 0 if mask_kind == "causal" else max(0, qs - window)
        outs.append(_chunked_attention(
            q[:, qs:qe], k[:, ks:qe], v[:, ks:qe], q_pos[qs:qe],
            k_pos[ks:qe], mask_kind, window, min(cfg.attn_chunk, qe - ks),
            score_dtype=torch_dtype(cfg.score_dtype)))
    return torch.cat(outs, dim=1)


def attention(q, k, v, q_pos, k_pos, *, mask_kind: str, window: int,
              cfg: ModelConfig) -> torch.Tensor:
    """GQA attention.  q: (B, Sq, H, D), k and v: (B, Sk, KH, D) ->
    (B, Sq, H, D).

    Without autograd, ``"auto"``, ``"chunked"`` and ``"pallas"`` run the
    flash kernel, DTensors on each rank's own rows (`on_local_rows`).
    Under autograd (`wants_grad` of q, k, v), or on ``meta`` tensors,
    the reference's dispatch holds: ``"auto"`` is dense when Sq·Sk <=
    2048², else chunked; ``"chunked"`` the plain chunked scan
    (`_qblock_attention` with ``cfg.q_block`` on a causal or windowed
    mask longer than a block); ``"pallas"`` reaches the kernel, which
    raises."""
    B, Sq, H, D = q.shape
    impl = cfg.attn_impl
    if impl not in FLASH_IMPLS + ("dense",):
        raise ValueError(f"attn_impl {impl!r}; the port has "
                         f"{FLASH_IMPLS + ('dense',)}")
    if impl in ("auto", "chunked") and (wants_grad(q, k, v)
                                        or on_meta(q, k, v)):
        if impl == "auto":
            impl = "dense" if Sq * k.shape[1] <= 2048 * 2048 else "chunked"
    elif impl in FLASH_IMPLS:
        impl = "pallas"
    if impl == "pallas":
        def kernel(q, k, v):
            return (flash_attention(q, k, v, q_pos, k_pos,
                                    mask_kind=mask_kind, window=window),)
        o, = on_local_rows(kernel, q, k, v)
        return o.reshape(B, Sq, H, D)
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    # the reference's constraint, then the batch split alone: the einsums
    # fold (batch, heads) into one dim, which DTensor (torch 2.11) refuses
    # when both are split
    q, k, v = (grad_dtype_barrier(batch_split_only(shard_activation(
        t, "batch", None, "act_heads", None))) for t in (q, k, v))
    if impl == "dense":
        o = _dense_attention(q, k, v, q_pos, k_pos, mask_kind, window)
    elif (cfg.q_block and mask_kind in ("causal", "window")
          and Sq > cfg.q_block):
        o = _qblock_attention(q, k, v, q_pos, k_pos, mask_kind, window, cfg)
    else:
        o = _chunked_attention(q, k, v, q_pos, k_pos, mask_kind, window,
                               cfg.attn_chunk,
                               score_dtype=torch_dtype(cfg.score_dtype))
    # its gradient arrives split as the output projection's: the batch
    # split alone again for the einsums' backward
    return grad_batch_split_only(o).reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------
# name -> (shape, logical axes): the axes name each dim for the sharding
# rules (`distributed.sharding`)
Defs = Dict[str, Tuple[Tuple[int, ...], Tuple[Optional[str], ...]]]


def attn_param_defs(cfg: ModelConfig, cross: bool = False) -> Defs:
    D, H, KH, Hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs = {"norm": ((D,), ("embed",)),
            "wq": ((D, H * Hd), ("embed", "qkv")),
            "wk": ((D, KH * Hd), ("embed", "kv")),
            "wv": ((D, KH * Hd), ("embed", "kv")),
            "wo": ((H * Hd, D), ("qkv", "embed"))}
    if cross:
        defs.update({"xnorm": ((D,), ("embed",)),
                     "xwq": ((D, H * Hd), ("embed", "qkv")),
                     "xwk": ((D, KH * Hd), ("embed", "kv")),
                     "xwv": ((D, KH * Hd), ("embed", "kv")),
                     "xwo": ((H * Hd, D), ("qkv", "embed"))})
    return defs


def _proj_qkv(x, p, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KH, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = split_ready(x @ p["wq"].to(dt), -1, H).reshape(B, S, H, Hd)
    k = split_ready(x @ p["wk"].to(dt), -1, KH).reshape(B, S, KH, Hd)
    v = split_ready(x @ p["wv"].to(dt), -1, KH).reshape(B, S, KH, Hd)
    return q, k, v


def _mixer_spec(mixer: str, cfg: ModelConfig):
    """(mask_kind, window, theta) for a self-attention mixer."""
    if mixer == "full":
        return "causal", 0, cfg.rope_theta
    if mixer == "swa":
        return "window", cfg.window_size, cfg.rope_theta
    if mixer == "local":
        return "window", cfg.local_window, cfg.rope_theta
    if mixer == "global":
        return "causal", 0, cfg.rope_theta_global
    if mixer == "enc":
        return "none", 0, cfg.rope_theta
    if mixer == "dec":
        return "causal", 0, cfg.rope_theta
    raise ValueError(mixer)


def _cross_attend(p, x, enc_out: torch.Tensor, q_pos, cfg: ModelConfig):
    """The cross-attention of a "dec" layer (pre-norm, residual): q from
    the decoder's ``x`` (B, S, D), K and V from ``enc_out`` (B, Se, D),
    no mask, no RoPE; ``q_pos`` only gives q's length."""
    B, S, _ = x.shape
    H, KH, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    h = rms_norm(x, p["xnorm"], cfg.norm_eps)
    q = split_ready(h @ p["xwq"].to(dt), -1, H).reshape(B, S, H, Hd)
    k = split_ready(enc_out @ p["xwk"].to(dt), -1, KH).reshape(B, -1, KH,
                                                                Hd)
    v = split_ready(enc_out @ p["xwv"].to(dt), -1, KH).reshape(B, -1, KH,
                                                                Hd)
    epos = torch.arange(enc_out.shape[1], dtype=torch.int32,
                        device=x.device)
    o = attention(q, k, v, q_pos, epos, mask_kind="none", window=0, cfg=cfg)
    return x + merged(o.reshape(B, S, -1), -1, H) @ p["xwo"].to(dt)


def attn_apply(p, x, mixer: str, cfg: ModelConfig, positions,
               enc_out: Optional[torch.Tensor] = None,
               want_cache: bool = False, max_seq: int = 0):
    """Full-sequence self-attention block (pre-norm, residual), then, in a
    "dec" layer given ``enc_out``, cross-attention (`_cross_attend`).
    Returns ``(x, cache)``; with ``want_cache`` the cache is the ring of
    the last ``attn_cache_len`` roped K/V rows (`attn_prefill_cache`)."""
    mask_kind, window, theta = _mixer_spec(mixer, cfg)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _proj_qkv(h, p, cfg)
    if mixer != "enc":                      # encoder uses no RoPE-on-frames
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    cache = (attn_prefill_cache(p, (k, v), mixer, cfg, max_seq)
             if want_cache else None)
    o = attention(q, k, v, positions, positions, mask_kind=mask_kind,
                  window=window, cfg=cfg)
    x = x + merged(o.reshape(x.shape[0], x.shape[1], -1), -1,
                   cfg.num_heads) @ p["wo"].to(x.dtype)
    if mixer == "dec" and enc_out is not None:
        x = _cross_attend(p, x, enc_out, positions, cfg)
    return x, cache


def attn_cache_len(mixer: str, cfg: ModelConfig, max_seq: int) -> int:
    mask_kind, window, _ = _mixer_spec(mixer, cfg)
    return min(max_seq, window) if mask_kind == "window" else max_seq


def attn_prefill_cache(p, x_normed_kv: Tuple[torch.Tensor, torch.Tensor],
                       mixer: str, cfg: ModelConfig, max_seq: int):
    """A ring cache from full-sequence K, V (RoPE applied): the last
    min(S, W) rows, row s in slot s % W, in ``cfg.kv_cache_dtype``
    (`cast_kv`)."""
    k, v = x_normed_kv
    B, S, KH, Hd = k.shape
    W = attn_cache_len(mixer, cfg, max_seq)
    cdt = getattr(torch, cfg.kv_cache_dtype)
    take = min(S, W)
    if not isinstance(k, DTensor):
        slots = (torch.arange(take, device=k.device) + (S - take)) % W
        out = {}
        for name, x in (("k", k), ("v", v)):
            out[name] = zeros_of((B, W, KH, Hd), cdt, k.device)
            _bits(out[name])[:, slots] = _bits(cast_kv(x[:, S - take:], cdt))
        return out

    def ring(x):
        # a DTensor ring (DTensor cannot write indexed rows into a split
        # dim; torch 2.11 has no `roll` strategy): row S - take + j lands
        # in slot (S - take + j) % W, so the rows padded with zeros to W
        # slots, their last r = (S - take) % W moved to the front
        rows = _bits(cast_kv(x[:, S - take:], cdt))
        if take < W:
            rows = torch.cat([rows, _zero_rows(rows, W - take)], dim=1)
        r = (S - take) % W
        if r:
            rows = torch.cat([rows[:, W - r:], rows[:, :W - r]], dim=1)
        rows = rows.contiguous()
        rows = rows.view(FP8) if cdt == FP8 else rows
        return shard_activation(rows, "cache_batch", "cache_seq",
                                "cache_kv", None)
    return {"k": ring(k), "v": ring(v)}


def _write_slot(ring: torch.Tensor, slot: int, row: torch.Tensor) -> None:
    """Write ``row`` (B, KH, Hd) into slot ``slot`` of the ring (B, W, KH,
    Hd) in place, in the ring's dtype (`cast_kv`).  A DTensor ring (split
    over its slots) is rewritten whole with a one-hot select, as the
    reference writes its ring: DTensor cannot index a split dim in
    place."""
    new = _bits(cast_kv(row, ring.dtype))
    if not isinstance(ring, DTensor):
        _bits(ring)[:, slot] = new
        return
    hit = torch.arange(ring.shape[1], device=row.device) == slot
    _bits(ring).copy_(torch.where(hit[None, :, None, None], new[:, None],
                                  _bits(ring)))


def _grouped_decode_attention(q, ck, cv, index: int, window: int):
    """The reference's `attn_decode` arithmetic (grouped-GQA einsum over
    the ring, no KV repeat): q (B, 1, H, D), ck and cv (B, W, KH, D)."""
    B, _, H, Hd = q.shape
    W, KH = ck.shape[1], ck.shape[2]
    G = H // KH
    valid = ring_validity(W, index, window, device=q.device) != 0
    qg = batch_split_only(q).reshape(B, 1, KH, G, Hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     ck.to(q.dtype).float()) * (Hd ** -0.5)
    s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                           device=s.device))
    pattn = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", pattn.to(q.dtype),
                        cv.to(q.dtype))


def attn_decode(p, x, cache, mixer: str, cfg: ModelConfig, index: int,
                enc_out: Optional[torch.Tensor] = None):
    """One-token decode.  x: (B, 1, D); cache: {"k", "v"} (B, W, KH, Hd)
    ring buffers (RoPE applied at write); ``index`` the token's absolute
    position (a Python int).  The token's K/V row is written into slot
    ``index % W`` in place (`cast_kv`); a "dec" layer given ``enc_out``
    (B, Se, D) then attends to it (`_cross_attend`, its K and V
    recomputed).  Returns ``(x, cache)``."""
    mask_kind, window, theta = _mixer_spec(mixer, cfg)
    ck, cv = cache["k"], cache["v"]
    W = ck.shape[1]
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _proj_qkv(h, p, cfg)
    pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
    q = rope(q, pos, theta)
    k = rope(k, pos, theta)
    _write_slot(ck, index % W, k[:, 0])
    _write_slot(cv, index % W, v[:, 0])
    win = window if mask_kind == "window" else 0
    impl = cfg.attn_impl
    B = x.shape[0]
    if impl in ("auto", "chunked") and on_meta(q, ck):
        impl = "dense"
    if impl in FLASH_IMPLS:
        o, = on_local_rows(lambda q, ck, cv: (decode_attention(
            q, ck, cv, index, window=win),), q, ck, cv)
    elif impl == "dense":
        o = _grouped_decode_attention(q, ck, cv, index, win)
    else:
        raise ValueError(f"attn_impl {impl!r}; the port has "
                         f"{FLASH_IMPLS + ('dense',)}")
    x = x + o.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    if mixer == "dec" and enc_out is not None:
        x = _cross_attend(p, x, enc_out, pos, cfg)
    return x, cache


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------
def ffn_param_defs(cfg: ModelConfig, kind: str) -> Defs:
    D, Fd = cfg.d_model, cfg.d_ff
    if kind == "swiglu":
        return {"fnorm": ((D,), ("embed",)),
                "wi_gate": ((D, Fd), ("embed", "mlp")),
                "wi_up": ((D, Fd), ("embed", "mlp")),
                "wo_ffn": ((Fd, D), ("mlp", "embed"))}
    if kind == "gelu":
        return {"fnorm": ((D,), ("embed",)),
                "wi": ((D, Fd), ("embed", "mlp")),
                "wo_ffn": ((Fd, D), ("mlp", "embed"))}
    if kind == "moe":
        E, Fe = cfg.num_experts, cfg.moe_d_ff
        return {"fnorm": ((D,), ("embed",)),
                "router": ((D, E), ("embed", "expert")),
                "we_gate": ((E, D, Fe), ("expert", "embed", "expert_mlp")),
                "we_up": ((E, D, Fe), ("expert", "embed", "expert_mlp")),
                "we_down": ((E, Fe, D), ("expert", "expert_mlp", "embed"))}
    if kind == "none":
        return {}
    raise ValueError(kind)


def ffn_apply(p, x, kind: str, cfg: ModelConfig) -> torch.Tensor:
    if kind == "none":
        return x
    dt = x.dtype
    h = rms_norm(x, p["fnorm"], cfg.norm_eps)
    if kind == "swiglu":
        g = F.silu(h @ p["wi_gate"].to(dt))
        u = h @ p["wi_up"].to(dt)
        return x + (g * u) @ p["wo_ffn"].to(dt)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        u = F.gelu(h @ p["wi"].to(dt), approximate="tanh")
        return x + u @ p["wo_ffn"].to(dt)
    if kind == "moe":
        return x + moe_apply(p, h, cfg)
    raise ValueError(kind)


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row in
    `jax.lax.top_k`'s order: value descending, ties to the lower index (a
    stable descending sort; `torch.topk` may order ties otherwise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p, x: torch.Tensor, cfg: ModelConfig):
    """(gates (N, K) float32, experts (N, K) int64) of tokens ``x`` (N, D):
    the router's logits in float32 from a product in ``x``'s dtype, their
    softmax, its top K (`top_k`), the gates divided by max(their sum,
    1e-9)."""
    logits = (x @ p["router"].to(x.dtype)).float()
    gates, idx = top_k(torch.softmax(logits, dim=-1), cfg.experts_per_token)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx


def moe_groups(N: int, cfg: ModelConfig):
    """(groups, tokens a group, capacity of an expert in a group) of a
    dispatch of N tokens: min(moe_groups, N) groups, halved until they
    divide N; capacity max(ceil(Nl K / E * capacity_factor), K)."""
    Gr = min(cfg.moe_groups, N)
    while N % Gr:
        Gr //= 2
    Nl = N // Gr
    K, E = cfg.experts_per_token, cfg.num_experts
    cap = max(int(math.ceil(Nl * K / E * cfg.capacity_factor)), K)
    return Gr, Nl, cap


def moe_slots(idx: torch.Tensor, Gr: int, cap: int, E: int):
    """(experts, slots, keep), each (Gr, Nl·K) in the group's (token, k)
    order: a pair's place in its expert's buffer is the number of earlier
    pairs of its group routed to that expert (the exclusive cumsum of the
    one-hot); pairs at or past ``cap`` are dropped into the overflow slot
    ``cap``."""
    e_flat = idx.reshape(Gr, -1)
    onehot = F.one_hot(e_flat, E)
    pos = (onehot.cumsum(1) - onehot).gather(2, e_flat[..., None])[..., 0]
    keep = pos < cap
    return e_flat, torch.where(keep, pos, cap), keep


def moe_apply(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k routed experts (SwiGLU each) of normed ``h`` (B, S, D), the
    reference's `moe_apply`.  One position (decode): each token's K
    experts' weights are gathered, nothing is dropped.  More: tokens split
    into `moe_groups` groups, each (token, k) pair scattered into its
    expert's (capacity, D) buffer of its group (`moe_slots`), the experts
    run as batched products over (E, groups · capacity, D), each pair's
    output gathered back, weighted by its gate (0 if dropped) and summed
    over k in the compute dtype."""
    if isinstance(h, DTensor):
        # DTensor has no strategy for the dispatch's indexed writes
        # (`index_put_`, torch 2.11): the FFN runs on every rank's whole
        # tensors and hands its output back replicated
        y = moe_apply({k: whole(v) for k, v in p.items()}, whole(h), cfg)
        return replicated(y, h.device_mesh)
    B, S, D = h.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    dt = h.dtype
    N = B * S
    x = h.reshape(N, D)
    gates, idx = moe_route(p, x, cfg)
    if S == 1:
        wg = p["we_gate"][idx].to(dt)                     # (N, K, D, F)
        wu = p["we_up"][idx].to(dt)
        wd = p["we_down"][idx].to(dt)                     # (N, K, F, D)
        g = F.silu(torch.einsum("nd,nkdf->nkf", x, wg))
        u = torch.einsum("nd,nkdf->nkf", x, wu)
        y = torch.einsum("nkf,nkfd->nkd", g * u, wd)
        return (y * gates[..., None].to(dt)).sum(dim=1).reshape(B, S, D)
    Gr, Nl, cap = moe_groups(N, cfg)
    e_flat, slot, keep = moe_slots(idx, Gr, cap, E)
    grp = torch.arange(Gr, device=h.device)[:, None].expand_as(e_flat)
    xg = shard_activation(x.reshape(Gr, Nl, D), "moe_group", None, None)
    buf = h.new_zeros((Gr, E, cap + 1, D))
    # slots are unique but for the overflow slot, which is cut off
    buf[grp, e_flat, slot] = xg.repeat_interleave(K, dim=1)
    xe = buf[:, :, :cap].transpose(0, 1).reshape(E, Gr * cap, D)
    g = F.silu(torch.bmm(xe, p["we_gate"].to(dt)))
    u = torch.bmm(xe, p["we_up"].to(dt))
    ye = torch.bmm(g * u, p["we_down"].to(dt))            # (E, Gr·cap, D)
    ye = F.pad(ye.view(E, Gr, cap, D).transpose(0, 1), (0, 0, 0, 1))
    w = gates.reshape(Gr, Nl * K, 1).to(dt) * keep[..., None].to(dt)
    y = ye[grp, e_flat, slot] * w                         # (Gr, Nl·K, D)
    return y.view(Gr, Nl, K, D).sum(dim=2).reshape(B, S, D)


# ---------------------------------------------------------------------------
# Mamba2 SSD block
# ---------------------------------------------------------------------------
def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, W); w: (K, W).  Returns y and the
    new conv state (the last K - 1 inputs)."""
    K = w.shape[0]
    if state is None:
        xp = torch.cat([_zero_rows(x, K - 1), x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    return y, xp[:, -(K - 1):]


def ssd_param_defs(cfg: ModelConfig) -> Defs:
    D = cfg.d_model
    di = cfg.d_inner
    N, H = cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N
    return {"norm": ((D,), ("embed",)),
            "in_proj": ((D, 2 * di + 2 * N + H), ("embed", "ssm_in")),
            "conv_w": ((cfg.conv_width, conv_dim), ("conv", "ssm_conv")),
            "A_log": ((H,), ("ssm_heads",)),
            "D_skip": ((H,), ("ssm_heads",)),
            "dt_bias": ((H,), ("ssm_heads",)),
            "gnorm": ((di,), ("ssm_inner",)),
            "out_proj": ((di, D), ("ssm_inner", "embed"))}


def _ssd_inputs(p, x, cfg: ModelConfig, conv_state=None):
    """Shared in-proj + conv + split for prefill, forward and decode."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    # its gradient, gathered from the conv's and the splits', may come
    # split along the sequence: the batch split alone before the
    # product's backward folds (batch, sequence) (DTensor, torch 2.11)
    zxbcdt = grad_batch_split_only(h @ p["in_proj"].to(x.dtype))
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], state=conv_state)
    xbc = F.silu(xbc)
    xs, B_, C_ = torch.split(xbc, [di, N, N], dim=-1)
    B, S = x.shape[0], x.shape[1]
    xs = split_ready(xs, -1, H).reshape(B, S, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                    # (H,)
    return z, xs, B_, C_, dt, A, new_conv


def ssd_scan_chunked(xs, dt, A, B_, C_, chunk: int):
    """Chunked SSD (Mamba2 Alg. 1) in plain PyTorch, model layout.

    xs: (B, S, H, P); dt: (B, S, H); A: (H,); B_, C_: (B, S, N) (a single
    group).  Returns y (B, S, H, P) and the final state (B, H, P, N), both
    float32: `kernels.ssd_scan.ref.ssd_chunked_ref` in head-major rows.
    DTensor inputs: each rank scans its own rows (`on_local_rows`; no
    DTensor strategy for the flip in a cumsum's backward, torch 2.11)."""
    return on_local_rows(functools.partial(_ssd_scan_rows, chunk=chunk),
                         xs, dt, A, B_, C_)


def _ssd_scan_rows(xs, dt, A, B_, C_, chunk: int):
    Bb, S, H, P = xs.shape
    x = xs.transpose(1, 2).reshape(Bb * H, S, P)
    d = dt.transpose(1, 2).reshape(Bb * H, S)
    a = A[None].expand(Bb, H).reshape(Bb * H)
    y, state = ssd_chunked_ref(x, d, a, B_, C_, chunk)
    return (y.view(Bb, H, S, P).transpose(1, 2),
            state.view(Bb, H, P, state.shape[-1]))


def ssd_apply(p, x, cfg: ModelConfig, impl: str = "pallas",
              want_cache: bool = False):
    """Full-sequence SSD block (pre-norm, residual).  ``impl="pallas"``
    runs the scan kernel, ``"jnp"`` the chunked plain path.  Returns
    ``(x, cache)``; the cache holds the final state and the conv state."""
    z, xs, B_, C_, dt, A, conv_state = _ssd_inputs(p, x, cfg)
    if impl == "pallas":
        y, final_state = on_local_rows(
            functools.partial(ssd_scan, chunk=cfg.ssm_chunk),
            xs, dt, A, B_, C_)
    elif impl == "jnp":
        y, final_state = ssd_scan_chunked(xs, dt, A, B_, C_, cfg.ssm_chunk)
    else:
        raise ValueError(f"impl {impl!r}; the port has {SCAN_IMPLS}")
    y = y + xs.float() * p["D_skip"].float()[:, None]
    y = merged(y.reshape(x.shape[0], x.shape[1], cfg.d_inner), -1,
               cfg.ssm_heads)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["gnorm"], cfg.norm_eps)
    cache = ({"state": final_state, "conv": conv_state}
             if want_cache else None)
    return x + y @ p["out_proj"].to(x.dtype), cache


def ssd_decode(p, x, cache, cfg: ModelConfig, index: int):
    """One-token SSD step.  cache: {"state": (B, H, P, N) float32, "conv":
    (B, K - 1, conv_dim)}.  Returns ``(x, new cache)``."""
    z, xs, B_, C_, dt, A, conv_state = _ssd_inputs(
        p, x, cfg, conv_state=cache["conv"])
    Bb = x.shape[0]
    xs1 = xs[:, 0].float()                                # (B, H, P)
    dt1 = dt[:, 0]                                        # (B, H)
    B1 = B_[:, 0].float()                                 # (B, N)
    C1 = C_[:, 0].float()
    dA = torch.exp(dt1 * A)                               # (B, H)
    dBx = torch.einsum("bh,bn,bhp->bhpn", dt1, B1, xs1)
    state = evened(cache["state"] * dA[..., None, None] + dBx)
    y = torch.einsum("bhpn,bn->bhp", state, C1)
    y = y + xs1 * p["D_skip"].float()[:, None]
    y = y.reshape(Bb, 1, cfg.d_inner)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["gnorm"], cfg.norm_eps)
    return (x + y @ p["out_proj"].to(x.dtype),
            {"state": state, "conv": conv_state})


# ---------------------------------------------------------------------------
# RG-LRU block (RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------
def rglru_param_defs(cfg: ModelConfig) -> Defs:
    D, W, H = cfg.d_model, cfg.lru_width, cfg.num_heads
    bw = W // H
    return {"norm": ((D,), ("embed",)),
            "wx": ((D, W), ("embed", "lru")),
            "wy": ((D, W), ("embed", "lru")),
            "conv_w": ((cfg.conv_width, W), ("conv", "lru")),
            "gate_a": ((H, bw, bw), ("heads", "lru_block", "lru_block2")),
            "gate_x": ((H, bw, bw), ("heads", "lru_block", "lru_block2")),
            "a_param": ((W,), ("lru",)),
            "wout": ((W, D), ("lru", "embed"))}


_LRU_C = 8.0


def _rglru_gates(p, x):
    """x (..., W) -> (a, gated input), both float32: the recurrence
    coefficient a = exp(log_a) and sqrt(1 - a^2) i x, with the gates r and
    i block-diagonal per head."""
    H, bw, _ = p["gate_a"].shape
    xs = split_ready(x, -1, H).reshape(x.shape[:-1] + (H, bw)).float()
    r = torch.sigmoid(torch.einsum("...hb,hbc->...hc", xs,
                                   p["gate_a"].float()))
    i = torch.sigmoid(torch.einsum("...hb,hbc->...hc", xs,
                                   p["gate_x"].float()))
    r = r.reshape(x.shape)
    i = i.reshape(x.shape)
    a_param = p["a_param"].float()
    # jax.nn.softplus is logaddexp(x, 0)
    log_a = -_LRU_C * torch.logaddexp(a_param, torch.zeros_like(a_param)) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = mult * (i * x.float())
    return a, gated


def _rglru_inputs(p, x, cfg: ModelConfig, conv_state=None):
    """Shared norm + projections + conv + gates of forward and decode:
    (a, gated input, the output gate, the new conv state)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    dt = x.dtype
    u = h @ p["wx"].to(dt)                                 # (B, S, W)
    # jax.nn.gelu defaults to the tanh approximation
    ygate = F.gelu(h @ p["wy"].to(dt), approximate="tanh")
    u, new_conv = _causal_conv(u, p["conv_w"], state=conv_state)
    a, b = _rglru_gates(p, u)                              # float32
    return a, b, ygate, new_conv


def rglru_apply(p, x, cfg: ModelConfig, impl: str = "pallas",
                want_cache: bool = False):
    """Full-sequence recurrent block (pre-norm, residual).
    ``impl="pallas"`` runs the recurrence kernel, ``"jnp"`` the plain
    log-step scan.  Returns ``(x, cache)``; the cache holds the last
    hidden state (B, W) float32 and the conv state (B, K - 1, W)."""
    a, b, ygate, conv_state = _rglru_inputs(p, x, cfg)
    if impl == "pallas":
        hseq, = on_local_rows(lambda a, b: (rglru_scan(a, b),), a, b)
    elif impl == "jnp":
        hseq = rglru_scan_ref(a, b)
    else:
        raise ValueError(f"impl {impl!r}; the port has {SCAN_IMPLS}")
    dt = x.dtype
    y = (hseq.to(dt) * ygate) @ p["wout"].to(dt)
    # copies, so the cache does not keep the whole sequence alive
    cache = ({"state": hseq[:, -1].contiguous(),
              "conv": conv_state.contiguous()} if want_cache else None)
    return x + y, cache


def rglru_decode(p, x, cache, cfg: ModelConfig, index: int):
    """One-token RG-LRU step.  cache: {"state": (B, W) float32, "conv":
    (B, K - 1, W)}.  Returns ``(x, new cache)``."""
    a, b, ygate, conv_state = _rglru_inputs(p, x, cfg,
                                            conv_state=cache["conv"])
    state = a[:, 0] * cache["state"] + b[:, 0]
    dt = x.dtype
    y = (state[:, None].to(dt) * ygate) @ p["wout"].to(dt)
    return x + y, {"state": state, "conv": conv_state}


# ---------------------------------------------------------------------------
# block dispatcher
# ---------------------------------------------------------------------------
def block_param_defs(cfg: ModelConfig, mixer: str, ffn: str) -> Defs:
    """name -> (shape, logical axes) of one layer's parameters: the
    mixer's, then the FFN's."""
    if mixer == "rglru":
        defs = dict(rglru_param_defs(cfg))
    elif mixer == "ssd":
        defs = dict(ssd_param_defs(cfg))
    else:
        defs = dict(attn_param_defs(cfg, cross=(mixer == "dec")))
    defs.update(ffn_param_defs(cfg, ffn))
    return defs


def block_apply(p, x, mixer: str, ffn: str, cfg: ModelConfig, positions,
                enc_out=None, impl: str = "pallas", want_cache: bool = False,
                max_seq: int = 0):
    """One layer: the mixer, then the FFN.  Returns ``(x, cache)`` — the
    cache is None unless ``want_cache`` (prefill).  ``impl`` chooses the
    SSD scan and the RG-LRU recurrence (attention follows
    ``cfg.attn_impl``)."""
    if mixer == "rglru":
        x, cache = rglru_apply(p, x, cfg, impl=impl, want_cache=want_cache)
    elif mixer == "ssd":
        x, cache = ssd_apply(p, x, cfg, impl=impl, want_cache=want_cache)
    else:
        x, cache = attn_apply(p, x, mixer, cfg, positions, enc_out=enc_out,
                              want_cache=want_cache, max_seq=max_seq)
    return ffn_apply(p, x, ffn, cfg), cache


def block_decode(p, x, cache, mixer: str, ffn: str, cfg: ModelConfig,
                 index: int, enc_out=None):
    """One layer of one-token decode: ``(x, cache)`` after the mixer and
    the FFN."""
    if mixer == "rglru":
        x, cache = rglru_decode(p, x, cache, cfg, index)
    elif mixer == "ssd":
        x, cache = ssd_decode(p, x, cache, cfg, index)
    else:
        x, cache = attn_decode(p, x, cache, mixer, cfg, index,
                               enc_out=enc_out)
    return ffn_apply(p, x, ffn, cfg), cache
