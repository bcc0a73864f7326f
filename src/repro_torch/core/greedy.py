"""Greedy Round-Robin (Greedy-RRA) — the paper's §VII baseline (port of
`repro.core.greedy`).

Offload jobs from the start of the list to the ES until the budget T is
met; assign the remainder round-robin across the ED models until the ED
budget T is met; put any leftovers on model 1 (the least accurate).  O(n),
on the host; may violate T, exactly as in the paper.
"""
from __future__ import annotations

import numpy as np

from .types import OffloadInstance, Schedule


def greedy_rra(inst: OffloadInstance) -> Schedule:
    n, m, T = inst.n, inst.m, inst.T
    assignment = np.zeros(n, dtype=np.int64)

    es_time = 0.0
    j = 0
    while j < n and es_time + inst.p_es[j] <= T + 1e-12:
        assignment[j] = inst.m
        es_time += inst.p_es[j]
        j += 1

    ed_time = 0.0
    k = 0
    while j < n:
        i = k % m
        if ed_time + inst.p_ed[j, i] <= T + 1e-12:
            assignment[j] = i
            ed_time += inst.p_ed[j, i]
            j += 1
            k += 1
        else:
            break

    # leftovers -> model 1 (index 0); this is where T gets violated
    assignment[j:] = 0
    return Schedule(assignment=assignment, instance=inst, solver="greedy_rra",
                    status="ok")
