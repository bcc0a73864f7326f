"""Greedy local-only fill (port of `repro.core.faults.greedy_local_fill`).

The rest of the reference module — the chaos fault model, its sampling
and the degradation ladder — is not ported yet (ROADMAP §1 item 9)."""
from __future__ import annotations

import torch


def greedy_local_fill(lat_jobs, acc_local, budget, eligible):
    """For each eligible sample, in job order, pick the max-accuracy local
    model whose latency still fits the device's residual budget, and spend
    it.

    ``lat_jobs`` (D, n, m) per-sample local-model latencies, ``acc_local``
    (D, m) local accuracies, ``budget`` (D,) seconds, ``eligible`` (D, n)
    bool.  Returns ``(choice (D, n) int32 — model index, m = nothing fits
    —, fit (D, n) bool, time_used (D,))``.  Argmax ties break to the
    lowest model index.  The reference's ``lax.scan`` over jobs is a loop
    of n vectorized steps."""
    D, n, m = lat_jobs.shape
    dev = lat_jobs.device
    res0 = torch.as_tensor(budget, dtype=torch.float64,
                           device=dev).expand(D)
    res = res0
    lanes = torch.arange(D, device=dev)
    choices, fits_out = [], []
    for s in range(n):
        lat_j, elig_j = lat_jobs[:, s], eligible[:, s]
        fits = lat_j <= res[:, None] + 1e-12
        score = torch.where(fits, acc_local, -torch.inf)
        pick = score.argmax(dim=1)
        take = elig_j & fits.any(dim=1)
        spend = torch.where(take, lat_j[lanes, pick], 0.0)
        choices.append(torch.where(take, pick, m).to(torch.int32))
        fits_out.append(take)
        res = res - spend
    return (torch.stack(choices, dim=1), torch.stack(fits_out, dim=1),
            res0 - res)
