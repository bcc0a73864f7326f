"""Tiered plan execution (port of `repro.serving.executor`).

Executes a planning result — a `repro_torch.api.Solution` or a legacy
`serving.planner.Plan` — against real model apply functions (the ED ladder and the ES), keeping per-tier clocks
of *measured* wall time: the quantity Fig. 6 of the paper compares with
the predicted makespan.  Jobs routed to the same model run as one batched
call.  The apply functions of the port's launcher end in a host copy of
their accuracies, so each call's wall time includes the card's work.

``es_fail=True`` simulates an ES-tier outage inside the period: offloaded
jobs bounce and are replanned onto the ED ladder (the paper's m-model
special case) through `solve(..., es_disabled=True)`.  The reference's
``comm_simulator`` hook, which no caller sets, is not ported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from .._device import DeviceLike
from ..api import Problem, Solution, solve

# per-sample execution status codes (ExecutionReport.status).  A sample
# starts DROPPED and is promoted as its result lands, so a short apply-fn
# output (or a job no tier ever ran) is visible in the report.
EXEC_OK_ED = 0           # completed on the planned ED-ladder model
EXEC_OK_ES = 1           # completed on the ES tier
EXEC_FALLBACK_LOCAL = 2  # ES failed; completed via the ED-only replan
EXEC_DROPPED = 3         # no tier produced a result for this sample
EXEC_STATUS_NAMES = ("ok_ed", "ok_es", "fallback_local", "dropped")


@dataclasses.dataclass
class ExecutionReport:
    predicted_makespan: float
    ed_wall: float
    es_wall: float
    results: Dict[int, object]
    replanned: bool = False
    # (n,) int32 EXEC_* per sample; None only for a report that `execute`
    # did not build
    status: Optional[np.ndarray] = None

    @property
    def wall_makespan(self) -> float:
        return max(self.ed_wall, self.es_wall)

    @property
    def n_dropped(self) -> int:
        """Samples that fell through execution with no result (0 without
        a status)."""
        if self.status is None:
            return 0
        return int((self.status == EXEC_DROPPED).sum())


def _instance_of(plan_):
    """The planned instance, of a legacy `Plan` or an api `Solution`."""
    if hasattr(plan_, "schedule"):            # legacy Plan
        return plan_.schedule.instance
    return plan_.problem.to_instance()        # api Solution


def _predicted_makespan(plan_) -> float:
    if hasattr(plan_, "schedule"):
        return plan_.predicted_makespan
    return float(plan_.makespan)


def execute(plan_: Solution, apply_ed: List[Callable], apply_es: Callable,
            jobs: List[object], *, es_fail: bool = False,
            device: DeviceLike = None) -> ExecutionReport:
    """Run ``jobs`` as ``plan_`` routes them (``per_model``): a
    `Solution` or a legacy `Plan`.  ``device`` is where the ES-outage
    replan is solved (the card unless named)."""
    m = len(apply_ed)
    results: Dict[int, object] = {}
    ed_wall = 0.0
    es_wall = 0.0
    replanned = False
    status = np.full(len(jobs), EXEC_DROPPED, dtype=np.int32)

    def _land(ids, out, code):
        for j, r in zip(ids, out):
            results[int(j)] = r
            status[int(j)] = code

    es_ids = plan_.per_model.get(m, np.array([], np.int64))
    if len(es_ids):
        if es_fail:
            # ES unreachable: replan the bounced jobs on the ED ladder
            inst = _instance_of(plan_)
            sub = Problem(p_ed=inst.p_ed[es_ids], p_es=inst.p_es[es_ids],
                          acc=inst.acc, T=inst.T)
            fb = solve(sub, es_disabled=True, device=device)
            replanned = True
            for i in range(m):
                ids = es_ids[fb.per_model.get(i, np.array([], np.int64))]
                if len(ids):
                    t0 = time.perf_counter()
                    out = apply_ed[i]([jobs[j] for j in ids])
                    ed_wall += time.perf_counter() - t0
                    _land(ids, out, EXEC_FALLBACK_LOCAL)
        else:
            t0 = time.perf_counter()
            out = apply_es([jobs[j] for j in es_ids])
            es_wall += time.perf_counter() - t0
            _land(es_ids, out, EXEC_OK_ES)

    for i in range(m):
        ids = plan_.per_model.get(i, np.array([], np.int64))
        if len(ids):
            t0 = time.perf_counter()
            out = apply_ed[i]([jobs[j] for j in ids])
            ed_wall += time.perf_counter() - t0
            _land(ids, out, EXEC_OK_ED)

    return ExecutionReport(
        predicted_makespan=_predicted_makespan(plan_), ed_wall=ed_wall,
        es_wall=es_wall, results=results, replanned=replanned,
        status=status)
