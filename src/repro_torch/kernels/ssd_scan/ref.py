"""Plain PyTorch versions of the Mamba2 SSD scan.

* `ssd_sequential_ref` — the exact recurrence, the port of
  `repro.kernels.ssd_scan.ref.ssd_sequential_ref` (model layout):

      h_t = h_{t-1} exp(dt_t A) + dt_t B_t x_t        y_t = C_t . h_t

* `ssd_chunked_ref` — the chunked algorithm (Mamba2's Alg. 1, the
  reference's `layers.ssd_scan_chunked`) in the kernel's layout: x
  (B·H, S, P), dt (B·H, S), A (B·H,) or (B·H, 1), and B_, C_ (B, S, N)
  shared by the H heads of a batch row.  This is what `ops` runs on a CPU
  tensor and what the model's ``impl="jnp"`` path runs on any device.

Everything is computed in float32.  A sequence that is not a multiple of
the chunk is padded with dt = 0, which is inert (decay exp(0) = 1 and
x·dt = 0).  Inside a chunk the decay matrix exp(cum_t - cum_s) is taken
only on and below the diagonal: the upper triangle is set to -inf before
`exp` (`segsum`), never multiplied by a 0/1 mask, since exp of the upper
triangle overflows to inf once a chunk's cumulative decay passes ~88.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B_: torch.Tensor, C_: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dt (B, S, H); A (H,); B_, C_ (B, S, N).  Returns
    (y (B, S, H, P) float32, final state (B, H, P, N) float32)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    x, dt, A = x.float(), dt.float(), A.float()
    B_, C_ = B_.float(), C_.float()
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)                        # (B, H)
        h = h * decay[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B_[:, t], x[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, C_[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((Bb, 0, H, P))
    return y, h


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q): cum_i - cum_j on and below the diagonal,
    -inf above it."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    lower = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                  device=x.device))
    return seg.masked_fill(~lower, float("-inf"))


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B_: torch.Tensor, C_: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan in the kernel's layout.  x (B·H, S, P); dt
    (B·H, S); A (B·H,) or (B·H, 1); B_, C_ (B, S, N).  Returns (y (B·H, S,
    P) float32, final state (B·H, P, N) float32)."""
    BH, S, P = x.shape
    Bb, _, N = B_.shape
    H = BH // Bb
    Q = min(chunk, S)
    pad = (-S) % Q
    xf = x.float().reshape(Bb, H, S, P)
    dtf = dt.float().reshape(Bb, H, S)
    Af = A.float().reshape(Bb, H)
    Bf, Cf = B_.float(), C_.float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        dtf = F.pad(dtf, (0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    nc = (S + pad) // Q
    x_c = xf.reshape(Bb, H, nc, Q, P)
    dt_c = dtf.reshape(Bb, H, nc, Q)
    B_c = Bf.reshape(Bb, nc, Q, N)
    C_c = Cf.reshape(Bb, nc, Q, N)
    dA = dt_c * Af[:, :, None, None]                           # (B,H,nc,Q)
    xdt = x_c * dt_c[..., None]                                # (B,H,nc,Q,P)

    # intra-chunk (diagonal blocks)
    L = torch.exp(segsum(dA))                                  # (B,H,nc,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)         # (B,nc,Q,Q)
    Y = torch.einsum("bhcqk,bhckp->bhcqp", L * scores[:, None], xdt)

    # each chunk's own state
    cum = torch.cumsum(dA, dim=-1)                             # (B,H,nc,Q)
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bckn,bhckp->bhcpn", B_c,
                          xdt * decay_to_end[..., None])       # (B,H,nc,P,N)

    # inter-chunk recurrence: the state each chunk starts from
    chunk_decay = torch.exp(cum[..., -1])                      # (B,H,nc)
    carry = torch.zeros((Bb, H, P, N), dtype=torch.float32,
                        device=x.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, :, c]
    prev_states = torch.stack(prev, dim=2)                     # (B,H,nc,P,N)
    Y_off = torch.einsum("bcqn,bhcpn->bhcqp", C_c, prev_states) \
        * torch.exp(cum)[..., None]
    y = (Y + Y_off).reshape(Bb, H, S + pad, P)[:, :, :S]
    return y.reshape(BH, S, P), carry.reshape(BH, P, N)
