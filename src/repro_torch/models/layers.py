"""Dense layers of the LM: the port of the dense subset of
`repro.models.layers` (forward only).

Numerics follow the reference: parameters live in ``param_dtype``
(float32) and are cast to the compute ``dtype`` (bfloat16 by default) at
each use; norms accumulate in float32, attention scores and softmax run in
float32.

Attention (`attention`) has two implementations, chosen by
``cfg.attn_impl``:

  * ``"auto"``, ``"chunked"``, ``"pallas"`` — the flash attention kernel
    (`kernels.flash_attention`): the hand-written CUDA kernel on a CUDA
    tensor, its plain PyTorch version on a CPU tensor.  KV is passed
    un-repeated with group = H // KH; the reference repeats KV instead and
    both give q-head h the kv-head h // G.
  * ``"dense"`` — `_dense_attention`, the reference's dense path that
    materialises the (Sq, Sk) scores: plain PyTorch, used to compare.

The reference's sharding constraints (`shard_activation`) and backward
dtype barrier (`grad_dtype_barrier`) are no-ops in a forward pass on one
card and are not ported.  Parameter definitions map names to shapes (the
reference's logical sharding axes are dropped).  MoE FFNs, the SSD and
RG-LRU mixers, cross-attention and cache construction raise
`NotImplementedError` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig

NEG_INF = -1e30
FLASH_IMPLS = ("auto", "chunked", "pallas")

_ITEM = "ROADMAP §1 item 12"
NOT_PORTED = {
    "moe": f"{_ITEM}: moe",
    "ssd": f"{_ITEM}: the mamba2-130m forward with ssd_scan",
    "rglru": f"{_ITEM}: recurrentgemma with rglru_scan",
    "cross": f"{_ITEM}: enc-dec",
    "cache": f"{_ITEM}: prefill and decode_step with decode_attention",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet "
                               f"({NOT_PORTED[what]})")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
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


def attention(q, k, v, q_pos, k_pos, *, mask_kind: str, window: int,
              cfg: ModelConfig) -> torch.Tensor:
    """GQA attention.  q: (B, Sq, H, D), k and v: (B, Sk, KH, D) ->
    (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    impl = cfg.attn_impl
    if impl in FLASH_IMPLS:
        o = flash_attention(q, k, v, q_pos, k_pos, mask_kind=mask_kind,
                            window=window)
    elif impl == "dense":
        G = H // k.shape[2]
        if G > 1:
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
        o = _dense_attention(q, k, v, q_pos, k_pos, mask_kind, window)
    else:
        raise ValueError(f"attn_impl {impl!r}; the port has "
                         f"{FLASH_IMPLS + ('dense',)}")
    return o.reshape(B, Sq, H, D)


# ---------------------------------------------------------------------------
# attention block
# ---------------------------------------------------------------------------
Shapes = Dict[str, Tuple[int, ...]]


def attn_param_defs(cfg: ModelConfig, cross: bool = False) -> Shapes:
    D, H, KH, Hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cross:
        raise not_ported("cross")
    return {"norm": (D,), "wq": (D, H * Hd), "wk": (D, KH * Hd),
            "wv": (D, KH * Hd), "wo": (H * Hd, D)}


def _proj_qkv(x, p, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KH, Hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, H, Hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, KH, Hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, KH, Hd)
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


def attn_apply(p, x, mixer: str, cfg: ModelConfig, positions,
               enc_out: Optional[torch.Tensor] = None,
               want_cache: bool = False) -> torch.Tensor:
    """Full-sequence self-attention block (pre-norm, residual)."""
    if want_cache:
        raise not_ported("cache")
    if enc_out is not None:
        raise not_ported("cross")
    mask_kind, window, theta = _mixer_spec(mixer, cfg)
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _proj_qkv(h, p, cfg)
    if mixer != "enc":                      # encoder uses no RoPE-on-frames
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    o = attention(q, k, v, positions, positions, mask_kind=mask_kind,
                  window=window, cfg=cfg)
    return x + o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------
def ffn_param_defs(cfg: ModelConfig, kind: str) -> Shapes:
    D, Fd = cfg.d_model, cfg.d_ff
    if kind == "swiglu":
        return {"fnorm": (D,), "wi_gate": (D, Fd), "wi_up": (D, Fd),
                "wo_ffn": (Fd, D)}
    if kind == "gelu":
        return {"fnorm": (D,), "wi": (D, Fd), "wo_ffn": (Fd, D)}
    if kind == "moe":
        raise not_ported("moe")
    if kind == "none":
        return {}
    raise ValueError(kind)


def ffn_apply(p, x, kind: str, cfg: ModelConfig) -> torch.Tensor:
    if kind == "none":
        return x
    if kind == "moe":
        raise not_ported("moe")
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
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# block dispatcher
# ---------------------------------------------------------------------------
def block_param_defs(cfg: ModelConfig, mixer: str, ffn: str) -> Shapes:
    if mixer in ("rglru", "ssd"):
        raise not_ported(mixer)
    defs = dict(attn_param_defs(cfg, cross=(mixer == "dec")))
    defs.update(ffn_param_defs(cfg, ffn))
    return defs


def block_apply(p, x, mixer: str, ffn: str, cfg: ModelConfig, positions,
                enc_out=None, want_cache: bool = False) -> torch.Tensor:
    """One layer: the mixer, then the FFN.  Returns the new residual
    stream (the reference also returns a cache, which only prefill
    builds)."""
    if mixer in ("rglru", "ssd"):
        raise not_ported(mixer)
    x = attn_apply(p, x, mixer, cfg, positions, enc_out=enc_out,
                   want_cache=want_cache)
    return ffn_apply(p, x, ffn, cfg)
