"""Beyond-paper: the Lagrangian-dual fast scheduler (port of
`repro.core.dual`).

The problem's two knapsacks are treated apart:

  1. Dualize only the ED budget with a multiplier lam >= 0: each job's
     ED choice is argmax_i (a_i - lam * p_ij).
  2. Given those ED choices, the ES side is a 0/1 knapsack in the gains
     g_j = a_{m+1} - a_{i*(j)} with weights p_es_j and capacity T, filled
     greedily by descending density.
  3. Bisect lam (40 steps) to the smallest multiplier whose assignment
     meets the ED budget; where none does, every job takes its fastest
     local model (status "fallback").

No 2T guarantee is claimed (that is AMR^2's).  Two paths, as in the
reference:

* the NumPy oracle `dual_schedule` (`_recover`, `_ed_load`): one
  instance, a stable descending-density sort and a prefix sum;
* the batched tensor path `dual_one_batch` (`_recover_torch`,
  `_ed_load_torch`) over a leading lane axis, on the tensors' device.
  The bisection runs a fixed number of steps with `torch.where` carries
  and reads nothing back to the host.  Instead of a sort, each job's
  prefix load is a masked sum over the jobs at or before it in the
  stable descending-density order (ties by job index) — the reference's
  O(n^2) pairwise rank.  Its summation order differs from the oracle's
  cumulative sum, so a take/skip decision can differ only where a prefix
  load lands within float64 rounding of the boundary ``T + 1e-12``.

`dual_schedule_batch_arrays` and `dual_schedule_batch` wrap the tensor
path for host instance batches.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .types import InstanceBatch, OffloadInstance, Schedule


# --------------------------------------------------------------------------
# the NumPy oracle
# --------------------------------------------------------------------------
def _recover(inst: OffloadInstance, lam: float) -> np.ndarray:
    m, T = inst.m, inst.T
    a = inst.acc
    score = a[None, :-1] - lam * inst.p_ed          # (n, m)
    ed_choice = np.argmax(score, axis=1)
    gain = a[-1] - a[ed_choice]                     # accuracy gain if offloaded
    density = gain / np.maximum(inst.p_es, 1e-12)
    order = np.argsort(-density, kind="stable")
    cum = np.cumsum(inst.p_es[order])
    take = order[(cum <= T + 1e-12)]
    # a negative-gain offload never helps accuracy; the bisection raises
    # lam instead, so only non-negative gains are kept
    take = take[gain[take] >= 0]
    assign = ed_choice.copy()
    assign[take] = m
    return assign


def _ed_load(inst: OffloadInstance, assign: np.ndarray) -> float:
    on_ed = assign < inst.m
    if not on_ed.any():
        return 0.0
    j = np.nonzero(on_ed)[0]
    return float(inst.p_ed[j, assign[j]].sum())


def dual_schedule(inst: OffloadInstance, *, iters: int = 40) -> Schedule:
    """The dual scheduler on one instance (host NumPy, the oracle)."""
    T = inst.T
    # lam = 0: the unconstrained ED choice; feasible means done
    assign = _recover(inst, 0.0)
    if _ed_load(inst, assign) <= T + 1e-12:
        return Schedule(assignment=assign, instance=inst, solver="dual",
                        status="ok")
    lo, hi = 0.0, float(inst.acc[-1] / max(np.min(inst.p_ed), 1e-9))
    best = None
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cand = _recover(inst, mid)
        if _ed_load(inst, cand) <= T + 1e-12:
            best, hi = cand, mid
        else:
            lo = mid
    if best is None:
        # even the harshest multiplier failed (tiny T): every job on its
        # fastest local model, best effort
        cand = np.argmin(inst.p_ed, axis=1)
        return Schedule(assignment=cand, instance=inst, solver="dual",
                        status="fallback")
    return Schedule(assignment=best, instance=inst, solver="dual",
                    status="ok")


# --------------------------------------------------------------------------
# the batched tensor path
# --------------------------------------------------------------------------
def _recover_torch(p_ed, p_es, acc, T, lam):
    """`_recover` over lanes: ``p_ed`` (B, n, m), ``p_es`` (B, n), ``acc``
    (B, m+1), ``T`` and ``lam`` (B,).  Returns the assignment (B, n)
    int64.  First-max argmax, stable descending-density order (ties by
    job index), prefix-load knapsack fill, non-negative gains only."""
    n, m = p_ed.shape[1], p_ed.shape[2]
    score = acc[:, None, :m] - lam[:, None, None] * p_ed
    ed_choice = score.argmax(dim=2)
    gain = acc[:, m:] - torch.gather(acc, 1, ed_choice)
    density = gain / torch.clamp_min(p_es, 1e-12)
    idx = torch.arange(n, device=p_ed.device)
    # before[b, j, k]: job k sits at or before job j in the order
    dj, dk = density[:, :, None], density[:, None, :]
    before = (dk > dj) | ((dk == dj) & (idx[None, :] <= idx[:, None]))
    cum = torch.where(before, p_es[:, None, :], 0.0).sum(dim=2)
    keep = (cum <= T[:, None] + 1e-12) & (gain >= 0)
    return torch.where(keep, m, ed_choice)


def _ed_load_torch(p_ed, assign):
    """ED load (B,) of assignments (B, n)."""
    m = p_ed.shape[2]
    picked = torch.gather(p_ed, 2, assign.clamp(0, m - 1)[..., None])[..., 0]
    return torch.where(assign < m, picked, 0.0).sum(dim=1)


def dual_one_batch(p_ed, p_es, acc, T, iters: int = 40
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dual scheduler over a leading lane axis, on the tensors'
    device, float64: ``(assignment (B, n) int64, status (B,) int64)`` with
    0 ok and 1 fallback.  A fixed ``iters`` bisection steps, each lane
    carrying its bracket and best feasible assignment; no value is read
    back to the host."""
    B = p_ed.shape[0]
    zero = torch.zeros(B, dtype=p_ed.dtype, device=p_ed.device)
    assign0 = _recover_torch(p_ed, p_es, acc, T, zero)
    feas0 = _ed_load_torch(p_ed, assign0) <= T + 1e-12
    lo = zero
    hi = acc[:, -1] / torch.clamp_min(p_ed.amin(dim=(1, 2)), 1e-9)
    best = assign0
    has_best = torch.zeros(B, dtype=torch.bool, device=p_ed.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cand = _recover_torch(p_ed, p_es, acc, T, mid)
        feas = _ed_load_torch(p_ed, cand) <= T + 1e-12
        best = torch.where(feas[:, None], cand, best)
        lo = torch.where(feas, lo, mid)
        hi = torch.where(feas, mid, hi)
        has_best = has_best | feas
    fallback = p_ed.argmin(dim=2)
    assign = torch.where(feas0[:, None], assign0,
                         torch.where(has_best[:, None], best, fallback))
    status = (~(feas0 | has_best)).to(torch.int64)
    return assign, status


def dual_schedule_batch_arrays(batch: InstanceBatch, *, iters: int = 40,
                               device: DeviceLike = None):
    """`dual_one_batch` on a host `InstanceBatch`, run on ``device`` (the
    card unless named): ``(assignment (B, n) int64, status (B,) int64)``,
    0 ok and 1 fallback."""
    dev = resolve_device(device)

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    assign, status = dual_one_batch(f64(batch.p_ed), f64(batch.p_es),
                                    f64(batch.acc), f64(batch.T),
                                    iters=iters)
    return (assign.cpu().numpy().astype(np.int64),
            status.cpu().numpy().astype(np.int64))


def dual_schedule_batch(
        instances: Union[InstanceBatch, Sequence[OffloadInstance]], *,
        iters: int = 40, device: DeviceLike = None) -> List[Schedule]:
    """`dual_schedule` over same-shape instances in one batched call."""
    batch = instances if isinstance(instances, InstanceBatch) \
        else InstanceBatch.stack(list(instances))
    assign, status = dual_schedule_batch_arrays(batch, iters=iters,
                                                device=device)
    return [Schedule(assignment=assign[b], instance=batch[b], solver="dual",
                     status="ok" if status[b] == 0 else "fallback")
            for b in range(len(batch))]
