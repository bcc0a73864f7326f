"""Layers of the LM: the port of `repro.models.layers` up to the SSD and
RG-LRU mixers and the KV cache (forward, prefill and one-token decode).

Numerics follow the reference: parameters live in ``param_dtype``
(float32) and are cast to the compute ``dtype`` (bfloat16 by default) at
each use; norms accumulate in float32, attention scores and softmax run in
float32, the SSD scan, the RG-LRU gates and recurrence and their states
in float32.

Attention (`attention`, and `attn_decode` on the KV cache) has two
implementations, chosen by ``cfg.attn_impl``:

  * ``"auto"``, ``"chunked"``, ``"pallas"`` — the hand-written kernels:
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

The reference's sharding constraints (`shard_activation`) and backward
dtype barrier (`grad_dtype_barrier`) are no-ops in a forward pass on one
card and are not ported.  Parameter definitions map names to shapes (the
reference's logical sharding axes are dropped).  MoE FFNs and
cross-attention raise `NotImplementedError` naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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

_ITEM = "ROADMAP §1 item 12"
NOT_PORTED = {
    "moe": f"{_ITEM}: moe",
    "cross": f"{_ITEM}: enc-dec",
}
SCAN_IMPLS = ("pallas", "jnp")


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
               want_cache: bool = False, max_seq: int = 0):
    """Full-sequence self-attention block (pre-norm, residual).  Returns
    ``(x, cache)``; with ``want_cache`` the cache is the ring of the last
    ``attn_cache_len`` roped K/V rows (`attn_prefill_cache`)."""
    if enc_out is not None:
        raise not_ported("cross")
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
    x = x + o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"].to(x.dtype)
    return x, cache


def attn_cache_len(mixer: str, cfg: ModelConfig, max_seq: int) -> int:
    mask_kind, window, _ = _mixer_spec(mixer, cfg)
    return min(max_seq, window) if mask_kind == "window" else max_seq


def attn_prefill_cache(p, x_normed_kv: Tuple[torch.Tensor, torch.Tensor],
                       mixer: str, cfg: ModelConfig, max_seq: int):
    """A ring cache from full-sequence K, V (RoPE applied): the last
    min(S, W) rows, row s in slot s % W, in ``cfg.kv_cache_dtype``."""
    k, v = x_normed_kv
    B, S, KH, Hd = k.shape
    W = attn_cache_len(mixer, cfg, max_seq)
    cdt = getattr(torch, cfg.kv_cache_dtype)
    ck = torch.zeros((B, W, KH, Hd), dtype=cdt, device=k.device)
    cv = torch.zeros((B, W, KH, Hd), dtype=cdt, device=k.device)
    take = min(S, W)
    slots = (torch.arange(take, device=k.device) + (S - take)) % W
    ck[:, slots] = k[:, S - take:].to(cdt)
    cv[:, slots] = v[:, S - take:].to(cdt)
    return {"k": ck, "v": cv}


def _grouped_decode_attention(q, ck, cv, index: int, window: int):
    """The reference's `attn_decode` arithmetic (grouped-GQA einsum over
    the ring, no KV repeat): q (B, 1, H, D), ck and cv (B, W, KH, D)."""
    B, _, H, Hd = q.shape
    W, KH = ck.shape[1], ck.shape[2]
    G = H // KH
    valid = ring_validity(W, index, window, device=q.device) != 0
    qg = q.reshape(B, 1, KH, G, Hd)
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
    ``index % W`` in place; returns ``(x, cache)``."""
    if enc_out is not None:
        raise not_ported("cross")
    mask_kind, window, theta = _mixer_spec(mixer, cfg)
    ck, cv = cache["k"], cache["v"]
    W = ck.shape[1]
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _proj_qkv(h, p, cfg)
    pos = torch.full((1,), index, dtype=torch.int32, device=x.device)
    q = rope(q, pos, theta)
    k = rope(k, pos, theta)
    slot = index % W
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    win = window if mask_kind == "window" else 0
    impl = cfg.attn_impl
    B = x.shape[0]
    if impl in FLASH_IMPLS:
        o = decode_attention(q, ck, cv, index, window=win)
    elif impl == "dense":
        o = _grouped_decode_attention(q, ck, cv, index, win)
    else:
        raise ValueError(f"attn_impl {impl!r}; the port has "
                         f"{FLASH_IMPLS + ('dense',)}")
    x = x + o.reshape(B, 1, -1) @ p["wo"].to(x.dtype)
    return x, cache


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
# Mamba2 SSD block
# ---------------------------------------------------------------------------
def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, W); w: (K, W).  Returns y and the
    new conv state (the last K - 1 inputs)."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    return y, xp[:, -(K - 1):]


def ssd_param_defs(cfg: ModelConfig) -> Shapes:
    D = cfg.d_model
    di = cfg.d_inner
    N, H = cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * N
    return {"norm": (D,), "in_proj": (D, 2 * di + 2 * N + H),
            "conv_w": (cfg.conv_width, conv_dim), "A_log": (H,),
            "D_skip": (H,), "dt_bias": (H,), "gnorm": (di,),
            "out_proj": (di, D)}


def _ssd_inputs(p, x, cfg: ModelConfig, conv_state=None):
    """Shared in-proj + conv + split for prefill, forward and decode."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = di // H
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    zxbcdt = h @ p["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], state=conv_state)
    xbc = F.silu(xbc)
    xs, B_, C_ = torch.split(xbc, [di, N, N], dim=-1)
    B, S = x.shape[0], x.shape[1]
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                    # (H,)
    return z, xs, B_, C_, dt, A, new_conv


def ssd_scan_chunked(xs, dt, A, B_, C_, chunk: int):
    """Chunked SSD (Mamba2 Alg. 1) in plain PyTorch, model layout.

    xs: (B, S, H, P); dt: (B, S, H); A: (H,); B_, C_: (B, S, N) (a single
    group).  Returns y (B, S, H, P) and the final state (B, H, P, N), both
    float32: `kernels.ssd_scan.ref.ssd_chunked_ref` in head-major rows."""
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
        y, final_state = ssd_scan(xs, dt, A, B_, C_, cfg.ssm_chunk)
    elif impl == "jnp":
        y, final_state = ssd_scan_chunked(xs, dt, A, B_, C_, cfg.ssm_chunk)
    else:
        raise ValueError(f"impl {impl!r}; the port has {SCAN_IMPLS}")
    y = y + xs.float() * p["D_skip"].float()[:, None]
    y = y.reshape(x.shape[0], x.shape[1], cfg.d_inner)
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
    state = cache["state"] * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", state, C1)
    y = y + xs1 * p["D_skip"].float()[:, None]
    y = y.reshape(Bb, 1, cfg.d_inner)
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["gnorm"], cfg.norm_eps)
    return (x + y @ p["out_proj"].to(x.dtype),
            {"state": state, "conv": conv_state})


# ---------------------------------------------------------------------------
# RG-LRU block (RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------
def rglru_param_defs(cfg: ModelConfig) -> Shapes:
    D, W, H = cfg.d_model, cfg.lru_width, cfg.num_heads
    bw = W // H
    return {"norm": (D,), "wx": (D, W), "wy": (D, W),
            "conv_w": (cfg.conv_width, W), "gate_a": (H, bw, bw),
            "gate_x": (H, bw, bw), "a_param": (W,), "wout": (W, D)}


_LRU_C = 8.0


def _rglru_gates(p, x):
    """x (..., W) -> (a, gated input), both float32: the recurrence
    coefficient a = exp(log_a) and sqrt(1 - a^2) i x, with the gates r and
    i block-diagonal per head."""
    H, bw, _ = p["gate_a"].shape
    xs = x.reshape(x.shape[:-1] + (H, bw)).float()
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
        hseq = rglru_scan(a, b)
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
def block_param_defs(cfg: ModelConfig, mixer: str, ffn: str) -> Shapes:
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
