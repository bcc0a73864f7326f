"""Plain PyTorch versions for flash-decode.

* `ring_validity(W, index, window)` — the port of the reference's
  `decode_attention.ops.ring_validity`: which slots of a ring cache of W
  slots hold a live key when the token at absolute position ``index`` is
  decoded (its own slot, ``index % W``, was just written).  The same ring
  arithmetic as the reference's `layers.attn_decode`, wrap and window
  included.
* `decode_attention_ref(q, k, v, valid)` — the port of
  `repro.kernels.decode_attention.ref.decode_attention_ref` in the Pallas
  function's layout: q (B·KH, G, D), k and v (B·KH, W, D), valid (B·KH, W)
  int32.  K and V (float32, bfloat16 or float8_e4m3fn) are taken in q's
  type (as the reference's wrapper casts the cache), scores are float32 (``q·k`` times D^-1/2), invalid ones
  -1e30.  The rounding follows the Pallas kernel: ``p = exp(s - max)`` is
  cast to q's type before the PV product, the row sum adds the unrounded
  ``p``, and the output is ``(p V) / max(l, 1e-30)`` in q's type.  For
  float32 that is the reference's oracle up to summation order.
"""
from __future__ import annotations

import torch

NEG = -1e30


def ring_validity(W: int, index: int, window: int = 0,
                  device=None) -> torch.Tensor:
    """(W,) int32 validity for a ring cache of W slots at absolute
    ``index`` (the slot being written this step is ``index % W``)."""
    index = int(index)
    slots = torch.arange(W, device=device)
    slot = index % W
    wraps = index // W
    abs_pos = torch.where(slots <= slot, slots + wraps * W,
                          slots + (wraps - 1) * W)
    ok = (abs_pos >= 0) & (abs_pos <= index)
    if window:
        ok &= abs_pos > index - window
    return ok.to(torch.int32)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """q (B·KH, G, D); k, v (B·KH, W, D); valid (B·KH, W) int32.  Returns
    (B·KH, G, D) in q's type."""
    dt = q.dtype
    k, v = k.to(dt), v.to(dt)
    s = torch.einsum("bgd,bkd->bgk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    s = torch.where(valid[:, None, :] != 0, s,
                    torch.tensor(NEG, dtype=s.dtype, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bgk,bkd->bgd", p.to(dt).float(), v.float())
    return (pv / den).to(dt)
