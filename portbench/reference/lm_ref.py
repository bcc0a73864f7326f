"""Plain reference of the port's MoE language model (the Granite-3.0 MoE
widths), written from the model's equations, not from the port: plain
PyTorch in float32 with TF32 off, no kernel, no cache, no batching
tricks.  Imports nothing of the port.

The model, layer by layer (pre-norm, residual):

* ``x = embed[tokens]``;
* attention: ``h = rms(x) * (1 + norm)``; q, k, v projections; rotary
  embedding on q and k (theta 10,000, the halves rotated); causal
  attention of each q head over its KV group's head, scaled by
  ``Hd ** -0.5``; ``x += o @ wo``;
* MoE: ``h = rms(x) * (1 + fnorm)``; router logits ``h @ router``, their
  softmax, the top K experts (value descending, ties to the lower index),
  the K gates divided by their sum; each expert is ``(silu(h Wg) * (h
  Wu)) Wd``; ``x += sum_k gate_k expert_k(h)``.  A forward over many
  tokens dispatches them in groups, each expert taking at most ``cap``
  (token, k) pairs of a group in (token, k) order and dropping the rest
  (their gate counts 0); one token at a time (decode) drops nothing;
* ``logits = (rms(x) * (1 + final_norm)) @ unembed``, the vocabulary
  padding masked.

Departures from the published Granite-3.0 model, which the port shares:
no embedding, attention, residual or logits multipliers, and an
untied output head.

``quant`` rounds both operands of every matrix product to float8 e4m3
(one scale per tensor) before the float32 product: the benchmark's
control, the reference one precision below the model's bfloat16.
"""
from __future__ import annotations

import math
import sys
from typing import Any, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from portbench import common

NEG_INF = -1e30
E4M3_MAX = 448.0


def _q8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, quant: bool) -> torch.Tensor:
    a, b = a.float(), b.float()
    if quant:
        a, b = _q8(a), _q8(b)
    return a @ b


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    inv = torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps)
    return x * inv * (1.0 + scale.float())


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq[None, :]             # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def groups_of(n_tokens: int, cfg: Dict) -> int:
    """Tokens per dispatch group of a forward over ``n_tokens`` tokens:
    min(moe_groups, N) groups, halved until they divide N."""
    g = min(int(cfg["moe_groups"]), n_tokens)
    while n_tokens % g:
        g //= 2
    return n_tokens // g


def capacity(group: int, cfg: Dict) -> int:
    K, E = int(cfg["num_experts_per_tok"]), int(cfg["num_local_experts"])
    return max(int(math.ceil(group * K / E * float(cfg["capacity_factor"]))),
               K)


def _moe(h: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: Dict,
         group: int, n_grouped: int, quant: bool) -> torch.Tensor:
    """MoE output of ``h`` (N, d): the first ``n_grouped`` tokens in
    dispatch groups of ``group`` tokens with capacity, the rest undropped."""
    N, _ = h.shape
    K, E = int(cfg["num_experts_per_tok"]), int(cfg["num_local_experts"])
    probs = torch.softmax(_mm(h, lp["router"], quant), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :K], idx[:, :K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(gates, dtype=torch.bool)
    if n_grouped:
        cap = capacity(group, cfg)
        e = idx[:n_grouped].reshape(n_grouped // group, group * K)
        onehot = F.one_hot(e, E)
        before = (onehot.cumsum(1) - onehot).gather(2, e[..., None])[..., 0]
        keep[:n_grouped] = (before < cap).reshape(n_grouped, K)
    w = torch.where(keep, gates, 0.0)
    out = torch.zeros_like(h)
    for ex in range(E):
        tok, slot = (idx == ex).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = _mm(F.silu(_mm(x, lp["we_gate"][ex], quant))
                * _mm(x, lp["we_up"][ex], quant), lp["we_down"][ex], quant)
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


def forward_logits(params: Dict, tokens: torch.Tensor, cfg: Dict, *,
                   group: int, n_grouped: int, quant: bool = False,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """float32 logits (B, S, V) of ``tokens`` (B, S) at positions 0..S-1;
    the MoE dispatches the first ``n_grouped`` tokens of the flattened
    batch in groups of ``group`` (`groups_of`), the rest undropped.
    ``rows`` (optional, flat token indices) limits the logits returned to
    those tokens ((len(rows), V))."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S = tokens.shape
    d = int(cfg["hidden_size"])
    H, KH = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    Hd = d // H
    G = H // KH
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    dev = tokens.device
    pos = torch.arange(S, device=dev)
    x = params["embed"].float()[tokens.long()].reshape(B * S, d)
    blk = params["blocks"][0]
    causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    for layer in range(int(cfg["num_hidden_layers"])):
        lp = {k: v[layer] for k, v in blk.items()}
        h = _rms(x, lp["norm"], eps)
        q = _mm(h, lp["wq"], quant).reshape(B, S, H, Hd)
        k = _mm(h, lp["wk"], quant).reshape(B, S, KH, Hd)
        v = _mm(h, lp["wv"], quant).reshape(B, S, KH, Hd)
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        o = torch.empty((B, S, H, Hd), dtype=torch.float32, device=dev)
        for b in range(B):
            qb = q[b].permute(1, 0, 2)                            # H S Hd
            kb = k[b].permute(1, 0, 2).repeat_interleave(G, dim=0)
            vb = v[b].permute(1, 0, 2).repeat_interleave(G, dim=0)
            s = _mm(qb, kb.transpose(1, 2), quant) * Hd ** -0.5
            p = torch.softmax(s.masked_fill(~causal, NEG_INF), dim=-1)
            o[b] = _mm(p, vb, quant).permute(1, 0, 2)
        x = x + _mm(o.reshape(B * S, H * Hd), lp["wo"], quant)
        h = _rms(x, lp["fnorm"], eps)
        x = x + _moe(h, lp, cfg, group, n_grouped, quant)
    if rows is not None:
        x = x[rows]
    h = _rms(x, params["final_norm"], eps)
    logits = _mm(h, params["unembed"], quant)
    logits[:, int(cfg["vocab_size"]):] = NEG_INF
    return logits if rows is not None else logits.reshape(B, S, -1)


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's reference logit lies below the
    reference's best, per position: ``ref_logits`` (..., V), ``chosen``
    (...) token ids."""
    best = ref_logits.amax(dim=-1)
    picked = torch.gather(ref_logits, -1, chosen[..., None].long())
    return best - picked[..., 0]


def judge(g: torch.Tensor, limits: Dict[str, float]) -> List[Dict[str, Any]]:
    """The compared numbers of the gaps ``g`` of a run's checked answers:
    their mean, held to ``limits["logit_gap_mean"]``."""
    return [common.compared("logit_gap_mean", float(g.float().mean()),
                            limits["logit_gap_mean"])]


def check(params: Dict, cfg: Dict, batches: Iterable, limits: Dict[str, float]
          ) -> List[Dict[str, Any]]:
    """Work every ``(tokens, answers, dispatch)`` of ``batches`` out again
    and judge the answers' gaps (the widest gap, which one dispatch
    decision near a tie decides, is printed beside them)."""
    out = []
    with torch.no_grad():
        for tokens, answers, kw in batches:
            logits = forward_logits(params, tokens, cfg, **kw)
            out.append(gaps(logits, answers).flatten())
            del logits
    g = torch.cat(out)
    print(f"logit gaps over {g.numel()} answers: widest "
          f"{float(g.max())!r}, 99th percentile "
          f"{float(torch.quantile(g.float(), 0.99))!r}", file=sys.stderr)
    return judge(g, limits)
