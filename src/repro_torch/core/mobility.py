"""One-cell ES-pool admission (port of
`repro.core.mobility.admit_mask_pool`, the S=1 path of the reference's
period step).

The rest of the reference module — routing, segmented per-cell admission
and handover — belongs to the mobility scenario, not ported yet (ROADMAP
§1 item 9)."""
from __future__ import annotations

import torch


def admit_mask_pool(demands, T, n_servers: int):
    """First-fit admission of ``demands`` (D,) ES seconds (<= 0: not
    offloading) onto ``n_servers`` servers of capacity ``T``: ascending
    demand (device id on ties), least-loaded server first.

    The first-index least-loaded rule places the sorted demands round-robin
    on the servers (see the reference's docstring for the induction), so
    the running per-server loads are ``ceil(D/k)`` vectorized k-wide adds
    — the same per-server floating-point addition order as a D-step
    sequential first fit.  Rejections form a suffix of the sorted order.

    Returns ``(admitted (D,) bool, loads (n_servers,), inc (D,))`` with
    ``inc`` each device's inclusive server load at its placement (device
    order; 0 for non-offloaders)."""
    D = demands.shape[0]
    k = n_servers
    dev, dtype = demands.device, demands.dtype
    active = demands > 0
    eff = torch.where(active, demands, torch.inf)
    order = torch.argsort(eff, stable=True)
    sd = torch.where(active[order], demands[order], 0.0)
    rounds = -(-D // k)
    mat = torch.cat([sd, torch.zeros(rounds * k - D, dtype=dtype,
                                     device=dev)]).reshape(rounds, k)
    inc_rows = []
    loads = torch.zeros(k, dtype=dtype, device=dev)
    for row in mat:
        loads = loads + row
        inc_rows.append(loads)
    inc_mat = torch.stack(inc_rows)                   # (rounds, k)
    inc_sorted = inc_mat.reshape(rounds * k)[:D]
    fits = inc_sorted <= T + 1e-12
    posv = torch.arange(D, device=dev)
    first_viol = torch.where(active[order] & ~fits, posv, D).amin()
    adm_sorted = active[order] & fits & (posv < first_viol)
    admitted = torch.zeros(D, dtype=torch.bool, device=dev)
    admitted[order] = adm_sorted
    # final per-server load: the max of its admitted inclusive loads
    adm_mat = torch.cat([adm_sorted, torch.zeros(rounds * k - D,
                                                 dtype=torch.bool,
                                                 device=dev)])
    loads = torch.where(adm_mat.reshape(rounds, k), inc_mat, 0.0).amax(0)
    inc = torch.zeros(D, dtype=dtype, device=dev)
    inc[order] = inc_sorted
    return admitted, loads, inc
