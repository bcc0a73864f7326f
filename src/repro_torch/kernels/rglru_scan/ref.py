"""Plain PyTorch versions of the RG-LRU recurrence

    h_t = a_t h_{t-1} + b_t,   h_{-1} = 0,

elementwise over the LRU width, a and b of shape (B, S, W).

* `rglru_scan_ref` — the port of `repro.kernels.rglru_scan.ref
  .rglru_scan_ref`: an associative scan over S with the reference's
  combine ``(a1 a2, a2 b1 + b2)``, here as a log-step (Hillis–Steele)
  scan of ceil(log2 S) whole-tensor steps, so a sequence of 4096 tokens
  is 12 passes, not 4096 launches.  In float32; this is what `ops` runs
  on a CPU tensor and what the model's ``impl="jnp"`` path runs on any
  device.
* `rglru_sequential_ref` — the step-by-step loop in float64, the exact
  oracle of the tests.
* `rglru_tiled_ref` — the CUDA kernel's own order in float32: tiles of
  ``tile`` steps, each cut into ``split`` sub-chunks scanned from 0, their
  (prod a, local h) folded serially from the tile's incoming state, then
  each sub-chunk rescanned from its own.  A test oracle for the kernel,
  never on a model's path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, S, W) -> the hidden sequence h (B, S, W), float32."""
    a, h = a.float(), b.float()
    S = a.shape[1]
    d = 1
    while d < S:
        # element t absorbs the prefix ending at t - d: (a, h)_{t-d} then
        # (a, h)_t combine to (a_{t-d} a_t, a_t h_{t-d} + h_t)
        nh = h.clone()
        nh[:, d:] += a[:, d:] * h[:, :-d]
        if 2 * d < S:
            na = a.clone()
            na[:, d:] *= a[:, :-d]
            a = na
        h = nh
        d *= 2
    return h


def rglru_sequential_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The recurrence step by step in float64: h (B, S, W) float64."""
    a, b = a.double(), b.double()
    out = torch.empty_like(a)
    h = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as the
    card's ``fmaf``: the product is exact in float64, so only the sum
    rounds twice (float64, then float32), which differs from one rounding
    only on a float32 halfway case."""
    return (a.double() * b.double() + c.double()).float()


def rglru_tiled_ref(a: torch.Tensor, b: torch.Tensor, *, tile: int,
                    split: int) -> torch.Tensor:
    """h (B, S, W) float32 associated as the kernel associates it (see
    ``csrc/rglru_scan.cu``): per tile of ``tile`` steps (the last one
    padded with a = b = 0), sub-chunk k of ``tile // split`` steps scanned
    from 0 gives P_k (the product of its a, left to right) and H_k; the
    fold s <- P_j s + H_j over j from the previous tile's end state gives
    each sub-chunk's incoming state and the tile's end state; each
    sub-chunk is then rescanned from its incoming state.  Every step and
    fold is one fused multiply-add (`_fma`)."""
    if tile % split:
        raise ValueError(f"tile {tile} is not a multiple of split {split}")
    B, S, W = a.shape
    sub, n_tiles = tile // split, -(-S // tile)
    pad = (0, 0, 0, n_tiles * tile - S)
    a = F.pad(a.float(), pad).view(B, n_tiles, split, sub, W)
    x = F.pad(b.float(), pad).view(B, n_tiles, split, sub, W)
    h = torch.empty_like(a)
    carry = a.new_zeros(B, W)
    for n in range(n_tiles):
        an, xn = a[:, n], x[:, n]                       # (B, split, sub, W)
        p, hl = torch.ones_like(an[:, :, 0]), torch.zeros_like(an[:, :, 0])
        for i in range(sub):
            hl = _fma(an[:, :, i], hl, xn[:, :, i])
            p = p * an[:, :, i]
        incoming = []
        for j in range(split):
            incoming.append(carry)
            carry = _fma(p[:, j], carry, hl[:, j])
        hv = torch.stack(incoming, 1)                   # (B, split, W)
        for i in range(sub):
            hv = _fma(an[:, :, i], hv, xn[:, :, i])
            h[:, n, :, i] = hv
    return h.view(B, n_tiles * tile, W)[:, :S]
