"""Plain PyTorch version of one CCKP model group (AMDP, paper §VI-B).

Port of `repro.kernels.cckp_dp.ref.cckp_model_dp_ref` and of the
reference's traced-shift `core.amdp._model_dp_dyn`, batched over a
leading lane axis with a per-lane shift: for every lane b and cell (t, k)

    Y'[b, t, k]    = max_q  Y[b, t - q*p_b, k - q] + q*a_b
    bestq[b, t, k] = the first q attaining it,

q = 0 .. n_steps-1, reads outside the grid count as NEG.  ``s + q*a``
rounds twice (the product, then the sum), as every reference path does;
a fused multiply-add would round once and flip DP ties.
`cckp_models_dp_ref` chains it over the m models of one AMDP call.  The
wrappers in `ops.py` run these on CPU tensors; the CUDA kernel repeats
them cell by cell.
"""
from __future__ import annotations

import torch

NEG = -1e30  # -inf stand-in that survives float32 arithmetic


def cckp_model_dp_ref(y: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                      n_steps: int):
    """``y`` (B, T1, K1) float32 value grids, ``p`` (B,) int32 >= 0 this
    model's integerized time per lane, ``a`` (B,) float32 its accuracy.
    Returns ``(y' (B, T1, K1) float32, bestq (B, T1, K1) int32)``."""
    B, T1, K1 = y.shape
    dev = y.device
    best = torch.full_like(y, NEG)
    bestq = torch.zeros(y.shape, dtype=torch.int32, device=dev)
    t = torch.arange(T1, device=dev)
    p64 = p.to(torch.int64)
    for q in range(n_steps):
        # the q-th shifted view: src[b, t, k] = y[b, t - q p_b, k - q]
        src = torch.full_like(y, NEG)
        if q < K1:
            rows = t[None, :] - q * p64[:, None]                # (B, T1)
            idx = rows.clamp_min(0)[:, :, None].expand(B, T1, K1 - q)
            got = torch.gather(y[:, :, :K1 - q], 1, idx)
            src[:, :, q:] = torch.where((rows >= 0)[:, :, None], got, NEG)
        qa = torch.full_like(a, float(q)) * a                   # rounds once
        val = src + qa[:, None, None]                           # and again
        take = val > best
        best = torch.where(take, val, best)
        bestq = torch.where(take, q, bestq).to(torch.int32)
    return best, bestq


def cckp_models_dp_ref(y: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                       n_steps: int):
    """`cckp_model_dp_ref` over m models in turn: ``y`` (B, T1, K1)
    float32, ``p`` (B, m) int32, ``a`` (B, m) float32.  Returns ``(y_final
    (B, T1, K1) float32, bestq (m, B, T1, K1) int32)``."""
    tables = []
    for i in range(p.shape[1]):
        y, bestq = cckp_model_dp_ref(y, p[:, i], a[:, i], n_steps)
        tables.append(bestq)
    if not tables:
        return y.clone(), torch.zeros((0,) + tuple(y.shape),
                                      dtype=torch.int32, device=y.device)
    return y, torch.stack(tables)
