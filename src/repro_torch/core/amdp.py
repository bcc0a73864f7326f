"""AMDP — Accuracy Maximization using Dynamic Programming (paper §VI).

Port of `repro.core.amdp`.  For identical jobs (p_{ij} = p_i):

  Lemma 3 : an optimal schedule sends n_c = floor(T / p_{m+1}) jobs to the
            ES;
  Lemma 4 : the remaining n_l = n - n_c jobs form a cardinality-
            constrained knapsack (CCKP) over the m local models;
  Thm 3   : greedy ES fill + the exact CCKP DP is optimal for P_I.

The DP runs model by model as a (max,+) recurrence over the count q of
jobs given to that model, on a (T+1) x (n_l+1) float32 value grid, with a
per-model argmax-count table for an O(m) backtrack.  All m models run in
one launch of `kernels.cckp_dp.ops.models_dp` over the whole batch — the
CUDA kernel on the card, its plain version on the CPU — and the backtrack
gathers the counts on the same device, so only the (B, m) counts and the
feasibility flags come back to the host.

Times are integerized at ``resolution`` seconds with ceil(), so integer
feasibility implies real feasibility.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels.cckp_dp import ops as cckp_ops
from ..kernels.cckp_dp.ref import NEG
from .types import InstanceBatch, OffloadInstance, Schedule


def cckp_counts(p_int: np.ndarray, acc: np.ndarray, T_int: np.ndarray,
                n_l: np.ndarray, device: DeviceLike = None
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact CCKP on every lane of a batch sharing the model count m:
    counts ``q (B, m) >= 0`` with ``sum q == n_l`` and
    ``sum q * p_int <= T_int`` maximizing ``sum q * acc``.

    ``p_int`` (B, m) int, ``acc`` (B, m) (rounded to float32 for the DP),
    ``T_int`` and ``n_l`` (B,) int >= 0.  The lanes share one
    (T1, K1) grid, the batch's largest corner; the grid is exact padding
    (the recurrence is local in (t, k), so a lane's corner never sees
    cells beyond it).  The reference rounds the grid up to powers of two
    only to reuse jit traces; nothing here is traced.  One kernel launch
    for all m models.

    Returns ``(counts (B, m) int64, feasible (B,) bool, value (B,)
    float32)``; counts of infeasible lanes are 0."""
    dev = resolve_device(device)
    B, m = p_int.shape
    if B == 0:
        return (np.zeros((0, m), np.int64), np.zeros(0, bool),
                np.zeros(0, np.float32))
    T1 = int(T_int.max()) + 1
    K1 = int(n_l.max()) + 1
    y = torch.full((B, T1, K1), NEG, dtype=torch.float32, device=dev)
    y[:, :, 0] = 0.0
    p_t = torch.as_tensor(np.ascontiguousarray(p_int, np.int32), device=dev)
    a_t = torch.as_tensor(np.ascontiguousarray(acc, np.float32), device=dev)
    y, tables = cckp_ops.models_dp(y, p_t, a_t, K1)
    lanes = torch.arange(B, device=dev)
    t = torch.as_tensor(np.asarray(T_int, np.int64), device=dev)
    k = torch.as_tensor(np.asarray(n_l, np.int64), device=dev)
    value = y[lanes, t, k]
    counts = torch.zeros((B, m), dtype=torch.int64, device=dev)
    for i in range(m - 1, -1, -1):           # backtrack, on the device
        q = tables[i][lanes, t.clamp(0, T1 - 1), k.clamp(0, K1 - 1)]
        q = q.to(torch.int64)
        counts[:, i] = q
        t = t - q * p_t[:, i].to(torch.int64)
        k = k - q
    feasible = (value > NEG / 2).cpu().numpy()
    counts_h = counts.cpu().numpy()
    t_h, k_h = t.cpu().numpy(), k.cpu().numpy()
    if not ((k_h[feasible] == 0).all() and (t_h[feasible] >= 0).all()):
        raise RuntimeError("CCKP backtrack inconsistent")
    counts_h[~feasible] = 0
    return counts_h, feasible, value.cpu().numpy()


def solve_cckp(p: np.ndarray, a: np.ndarray, T_int: int, n_l: int, *,
               device: DeviceLike = None
               ) -> Tuple[Optional[np.ndarray], float]:
    """Exact CCKP of one instance: counts ``q_i >= 0``, ``sum q_i == n_l``,
    ``sum q_i * p_i <= T_int``, maximizing ``sum q_i * a_i``.  Returns
    ``(counts (m,), value)`` or ``(None, -inf)`` when infeasible."""
    counts, feasible, value = cckp_counts(
        np.asarray(p, np.int64)[None], np.asarray(a, np.float64)[None],
        np.array([T_int]), np.array([n_l]), device)
    if not feasible[0]:
        return None, -math.inf
    return counts[0], float(value[0])


def _integerize(p_ed_row: np.ndarray, T: np.ndarray, resolution: float):
    """``(p_int (B, m) int64, T_int (B,) int64)``: times in ``resolution``
    steps, ceil for the jobs and floor for the budget."""
    p_int = np.maximum(
        np.ceil(p_ed_row / resolution - 1e-9).astype(np.int64), 0)
    T_int = np.floor(np.asarray(T, np.float64) / resolution
                     + 1e-9).astype(np.int64)
    return p_int, T_int


def amdp_arrays(p_ed_row: np.ndarray, p_es: np.ndarray, acc: np.ndarray,
                T: np.ndarray, n: np.ndarray, *, resolution: float = 1e-3,
                device: DeviceLike = None):
    """AMDP over a batch of identical-job devices given as arrays: device
    b has ``n[b]`` jobs, each taking ``p_ed_row[b]`` (m,) on the local
    models and ``p_es[b]`` on the ES, accuracies ``acc[b]`` (m+1,) and
    budget ``T[b]``.  One DP per model count m; devices whose jobs all fit
    the ES (n_l = 0) skip it.

    Returns ``(assignment (B, max n) int64, infeasible (B,) bool)``: device
    b's first ``n_l`` jobs go to the local models in index order (counts
    from the DP; the fastest model everywhere when P_I is infeasible), the
    rest — and every slot past ``n[b]`` — to the ES (index m)."""
    p_ed_row = np.asarray(p_ed_row, np.float64)
    p_es = np.asarray(p_es, np.float64)
    acc = np.asarray(acc, np.float64)
    T = np.asarray(T, np.float64)
    n = np.asarray(n, np.int64)
    B, m = p_ed_row.shape
    n_max = int(n.max()) if B else 0
    # Lemma 3: greedy ES fill
    fill = np.floor(T / np.where(p_es > 0, p_es, 1.0) + 1e-12)
    n_c = np.where(p_es <= 0, n, np.minimum(n, fill).astype(np.int64))
    n_l = n - n_c
    counts = np.zeros((B, m), np.int64)
    infeasible = np.zeros(B, bool)
    dp = np.nonzero(n_l > 0)[0]
    if len(dp):
        p_int, T_int = _integerize(p_ed_row[dp], T[dp], resolution)
        c, feasible, _ = cckp_counts(p_int, acc[dp, :m], T_int, n_l[dp],
                                     device)
        counts[dp] = c
        infeasible[dp] = ~feasible
    # job j < n_l goes to the first model whose running count exceeds j
    j = np.arange(n_max)
    model = (j[None, None, :] >= np.cumsum(counts, axis=1)[:, :, None]
             ).sum(axis=1)                                      # (B, n_max)
    fastest = np.argmin(p_ed_row, axis=1)
    model = np.where(infeasible[:, None], fastest[:, None], model)
    assignment = np.where(j[None, :] < n_l[:, None], model, m)
    return assignment.astype(np.int64), infeasible


def _check_identical(instances: Sequence[OffloadInstance]) -> None:
    for inst in instances:
        if not inst.is_identical():
            raise ValueError(
                "amdp_batch requires identical jobs; use amr2_batch_arrays")


def amdp_batch(instances: Union[InstanceBatch, Sequence[OffloadInstance]],
               *, resolution: float = 1e-3,
               device: DeviceLike = None) -> List[Schedule]:
    """AMDP over a fleet of identical-job instances (any job counts): one
    DP launch per model-count group, assignments bit-identical to the
    scalar `amdp`."""
    if isinstance(instances, InstanceBatch):
        insts = [instances[b] for b in range(len(instances))]
    else:
        insts = list(instances)
    _check_identical(insts)
    scheds: List[Optional[Schedule]] = [None] * len(insts)
    groups: dict = {}
    for idx, inst in enumerate(insts):
        groups.setdefault(inst.m, []).append(idx)
    for m, idxs in groups.items():
        sub = [insts[i] for i in idxs]
        assignment, infeasible = amdp_arrays(
            np.stack([i.p_ed[0] if i.n else np.zeros(m) for i in sub]),
            np.array([i.p_es[0] if i.n else 0.0 for i in sub]),
            np.stack([i.acc for i in sub]), np.array([i.T for i in sub]),
            np.array([i.n for i in sub]), resolution=resolution,
            device=device)
        for row, idx in enumerate(idxs):
            inst = insts[idx]
            scheds[idx] = Schedule(
                assignment=assignment[row, :inst.n].copy(), instance=inst,
                solver="amdp",
                status="infeasible" if infeasible[row] else "ok")
    return scheds  # type: ignore[return-value]


def amdp(inst: OffloadInstance, *, resolution: float = 1e-3,
         device: DeviceLike = None) -> Schedule:
    """Optimal schedule for identical jobs (problem P_I)."""
    if not inst.is_identical():
        raise ValueError("AMDP requires identical jobs; use amr2() instead")
    return amdp_batch([inst], resolution=resolution, device=device)[0]


def amdp_hetero_comm(p_ed_models: np.ndarray, p_es_proc: float,
                     comm: np.ndarray, acc: np.ndarray, T: float, *,
                     resolution: float = 1e-3,
                     device: DeviceLike = None) -> Schedule:
    """Paper §VI remark: identical processing times but per-job
    communication times.  Offload in increasing order of c_j until the ES
    budget is spent (optimal by a swap argument when processing is
    identical), then solve the CCKP for the rest."""
    comm = np.asarray(comm, dtype=np.float64)
    n = len(comm)
    m = len(p_ed_models)
    order = np.argsort(comm, kind="stable")
    es_total = 0.0
    offload = []
    for j in order:
        t = comm[j] + p_es_proc
        if es_total + t <= T + 1e-12:
            offload.append(j)
            es_total += t
        else:
            break
    offload = set(offload)
    local = [j for j in range(n) if j not in offload]

    inst = OffloadInstance(p_ed=np.tile(p_ed_models, (n, 1)),
                           p_es=comm + p_es_proc, acc=acc, T=T)
    assignment = np.full(n, m, dtype=np.int64)
    if local:
        p_int, T_int = _integerize(np.asarray(p_ed_models, np.float64)[None],
                                   np.array([T]), resolution)
        counts, _ = solve_cckp(p_int[0], np.asarray(acc)[:m], int(T_int[0]),
                               len(local), device=device)
        if counts is None:
            assignment[local] = int(np.argmin(p_ed_models))
            return Schedule(assignment=assignment, instance=inst,
                            solver="amdp_hetero", status="infeasible")
        k = 0
        for i in range(m):
            for _ in range(counts[i]):
                assignment[local[k]] = i
                k += 1
    return Schedule(assignment=assignment, instance=inst,
                    solver="amdp_hetero", status="ok")
