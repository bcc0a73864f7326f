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
"""
from __future__ import annotations

import torch


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
