"""Plain PyTorch version of the flash attention forward.

Port of `repro.kernels.flash_attention.ref.attention_ref`, in the kernel's
layout: q (B·KH·G, Sq, D), k and v (B·KH, Sk, D), q-head row b reading kv
head b // group (KV is not repeated).  Positions are 0 .. Sq-1 and
0 .. Sk-1, and the mask comes from them:

    none    every key
    causal  key j <= query i
    window  i - window < j <= i

Scores are float32 (``q·k`` then times D^-1/2), masked ones -1e30.  The
rounding follows the Pallas kernel: ``p = exp(s - max)`` is cast to the
input type before the PV product, the row sum ``l`` adds the unrounded
``p``, and the output is ``(p V) / max(l, 1e-30)`` cast back.  For float32
inputs that is `attention_ref` up to summation order; for bfloat16 it is
the kernel's rounding of ``p`` with a single running max per row.  The
wrapper in `ops.py` runs this on CPU tensors; the CUDA kernel computes the
same thing block by block.
"""
from __future__ import annotations

import torch

NEG = -1e30
MASK_KINDS = ("none", "causal", "window")


def index_mask(mask_kind: str, Sq: int, Sk: int, window: int,
               device) -> torch.Tensor:
    """(Sq, Sk) bool: True where key j is live for query i."""
    if mask_kind not in MASK_KINDS:
        raise ValueError(f"mask_kind must be one of {MASK_KINDS}, "
                         f"got {mask_kind!r}")
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    live = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if mask_kind in ("causal", "window"):
        live &= kp <= qp
    if mask_kind == "window":
        live &= kp > qp - window
    return live


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mask_kind: str = "causal", window: int = 0,
                  group: int = 1) -> torch.Tensor:
    """q (B·KH·G, Sq, D); k, v (B·KH, Sk, D) with G = ``group``.  Returns
    (B·KH·G, Sq, D) in q's dtype."""
    BH, Sq, D = q.shape
    BKH, Sk, _ = k.shape
    s = torch.einsum("bgqd,bkd->bgqk",
                     q.reshape(BKH, group, Sq, D).float(), k.float())
    s = s * D ** -0.5
    live = index_mask(mask_kind, Sq, Sk, window, q.device)
    s = torch.where(live, s, torch.tensor(NEG, dtype=s.dtype,
                                          device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bgqk,bkd->bgqd", p.to(v.dtype).float(), v.float())
    return (pv / den).to(q.dtype).reshape(BH, Sq, D)
