"""Period-T serving loop (port of `repro.serving.runtime`; the paper's
deployment model, §III-C).

Every period: build the instance from the current `TierProfile`, plan
through the front door (`api.solve` on `Problem.from_instance`), execute
across the tiers, then audit: if the measured ED wall time drifts past the
profile's prediction by more than ``straggler_threshold``, the profile's
p_ed is EMA-rescaled so the next period plans for the degraded tier (the
straggler loop).  An ES outage inside a period triggers the executor's
fallback replan.  Any registry policy plans here (``"auto"``, ``"amr2"``,
``"amdp"``, ``"dual"``, ``"greedy"``), on ``device`` at B = 1 (the
reference plans a single problem with its NumPy oracles).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np

from .._device import DeviceLike, resolve_device
from ..api import Problem, Solution, solve
from .executor import ExecutionReport, execute
from .profile import TierProfile


def audit_profile(profile: TierProfile, predicted_ed: float,
                  measured_ed: float, *, threshold: float = 1.5,
                  ema: float = 0.5):
    """Straggler audit: when the measured ED wall time drifts past
    ``threshold x`` the profile's prediction, return a profile whose p_ed
    is rescaled toward the observed slowdown,
    ``p_ed * ((1 - ema) + ema * ratio)``.

    Returns ``(profile, updated)``; the input profile is never mutated."""
    if predicted_ed <= 0:
        return profile, False
    ratio = measured_ed / max(predicted_ed, 1e-9)
    if ratio <= threshold:
        return profile, False
    scaled = dataclasses.replace(
        profile, p_ed=profile.p_ed * ((1 - ema) + ema * ratio))
    return scaled, True


@dataclasses.dataclass
class PeriodStats:
    n_jobs: int
    policy: str
    predicted_makespan: float
    wall_makespan: float
    total_accuracy: float
    plan_seconds: float
    violation: float
    replanned: bool
    profile_updated: bool
    n_dropped: int = 0    # samples with no result (executor EXEC_DROPPED)


class ServingRuntime:
    """The single-device period loop over a model ladder: ``apply_ed[i]``
    runs ED model i on a list of jobs, ``apply_es`` the ES model; each
    returns one result per job.  ``device`` is where plans are solved (the
    card unless named)."""

    def __init__(self, profile: TierProfile, apply_ed: List[Callable],
                 apply_es: Callable, *, T: float, policy: str = "auto",
                 straggler_threshold: float = 1.5, ema: float = 0.5,
                 device: DeviceLike = None):
        self.profile = profile
        self.apply_ed = apply_ed
        self.apply_es = apply_es
        self.T = T
        self.policy = policy
        self.straggler_threshold = straggler_threshold
        self.ema = ema
        self.device = resolve_device(device)
        self.history: List[PeriodStats] = []

    def run_period(self, jobs: List[object], job_classes: np.ndarray, *,
                   es_fail: bool = False) -> PeriodStats:
        inst = self.profile.instance(job_classes, self.T)
        sol = solve(Problem.from_instance(inst), policy=self.policy,
                    device=self.device)
        report = execute(sol, self.apply_ed, self.apply_es, jobs,
                         es_fail=es_fail, device=self.device)
        updated = self._audit(sol, report)
        stats = PeriodStats(
            n_jobs=len(jobs), policy=sol.solver_name,
            predicted_makespan=float(sol.makespan),
            wall_makespan=report.wall_makespan,
            total_accuracy=float(sol.accuracy),
            plan_seconds=sol.plan_seconds,
            violation=max(0.0, report.wall_makespan / self.T - 1.0),
            replanned=report.replanned, profile_updated=updated,
            n_dropped=report.n_dropped)
        self.history.append(stats)
        return stats

    def _audit(self, sol: Solution, report: ExecutionReport) -> bool:
        """Compare the measured ED wall time with the plan's ED makespan;
        EMA-update the profile on drift.  Replanned periods are skipped:
        their measured walls reflect the fallback schedule, not the
        profile being audited."""
        if report.replanned:
            return False
        self.profile, updated = audit_profile(
            self.profile, float(sol.ed_makespan), report.ed_wall,
            threshold=self.straggler_threshold, ema=self.ema)
        return updated
