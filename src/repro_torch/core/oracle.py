"""Exact ILP oracle by exhaustive enumeration, for tests (n <= ~10).

Port of `repro.core.oracle`: enumerates all (m+1)^n assignments in
vectorised chunks; returns an optimal schedule of problem P, or None when
P is infeasible.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .types import OffloadInstance, Schedule

_CHUNK = 1 << 18


def brute_force(inst: OffloadInstance) -> Optional[Schedule]:
    n, m, T = inst.n, inst.m, inst.T
    mp1 = m + 1
    total = mp1 ** n
    if total > 5e7:
        raise ValueError(f"brute_force: {total} assignments is too many")

    # per-tier time of job j on model i (the other tier's column is 0)
    ed_t = np.concatenate([inst.p_ed, np.zeros((n, 1))], axis=1)  # (n, m+1)
    es_t = np.concatenate([np.zeros((n, m)), inst.p_es[:, None]], axis=1)

    best_val = -np.inf
    best_assign = None
    radix = mp1 ** np.arange(n)
    for start in range(0, total, _CHUNK):
        idx = np.arange(start, min(start + _CHUNK, total))
        digits = (idx[:, None] // radix[None, :]) % mp1        # (chunk, n)
        ed_load = np.take_along_axis(
            ed_t[None, :, :].repeat(len(idx), 0), digits[:, :, None], 2
        )[:, :, 0].sum(axis=1)
        es_load = np.take_along_axis(
            es_t[None, :, :].repeat(len(idx), 0), digits[:, :, None], 2
        )[:, :, 0].sum(axis=1)
        feas = (ed_load <= T + 1e-12) & (es_load <= T + 1e-12)
        if not feas.any():
            continue
        val = inst.acc[digits].sum(axis=1)
        val = np.where(feas, val, -np.inf)
        k = int(np.argmax(val))
        if val[k] > best_val:
            best_val = float(val[k])
            best_assign = digits[k].copy()

    if best_assign is None:
        return None
    return Schedule(assignment=best_assign.astype(np.int64), instance=inst,
                    solver="oracle", status="ok")
