"""Deprecated planner entry points: thin shims over `repro_torch.api`
(port of `repro.serving.planner`).

The front door is ``api.solve`` (one `Problem` or a `FleetProblem`) and
``api.solve_many`` (mixed-shape sequences).  Migration map:

  ==============================  =====================================
  legacy                          `repro_torch.api`
  ==============================  =====================================
  ``plan(inst, policy=...)``      ``solve(Problem.from_instance(inst),
                                  policy=...)``
  ``plan_batch(insts)``           ``solve_many(insts)``
  ``plan_batch_arrays(batch)``    ``solve(FleetProblem.from_batch(batch))``
  ``replan_without_es(inst)``     ``solve(inst, es_disabled=True)``
  ``replan_without_es_batch(b)``  ``solve(FleetProblem.from_batch(b,
                                  real_mask), es_disabled=True)``
  ==============================  =====================================

Each shim warns (``DeprecationWarning``) once per process and delegates.
The backend defaults to ``"torch"`` for single problems too, on
``device`` (the card unless named), as everywhere in the port.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .. import api
from .._device import DeviceLike
from ..core.problem import FleetProblem, Problem, Solution
from ..core.types import InstanceBatch, OffloadInstance, Schedule

_WARNED: set = set()


def _deprecated(name: str, replacement: str) -> None:
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"repro_torch.serving.{name} is deprecated; use {replacement} "
        f"(see repro_torch.api)", DeprecationWarning, stacklevel=3)


def _reset_deprecation_warnings() -> None:
    """Test hook: make every shim warn again."""
    _WARNED.clear()


def _reject_bound_only(policy: str) -> None:
    """The legacy planner never returned bound-only pseudo-schedules: a
    bound-only policy (``lp``) raises; ``api.solve(..., policy="lp")``
    gives the bound."""
    if policy != "auto" and api.get_solver(policy).info.bound_only:
        raise ValueError(
            f"policy {policy!r} is bound-only and was never a legacy "
            f"planner policy; call repro_torch.api.solve(..., "
            f"policy={policy!r}) for the bound")


@dataclasses.dataclass
class Plan:
    """Legacy single-device planning result (wraps a core `Schedule`)."""
    schedule: Schedule
    plan_seconds: float
    policy: str
    # model index -> job ids, computed on first use
    _per_model: Optional[Dict[int, np.ndarray]] = dataclasses.field(
        default=None, repr=False)

    @property
    def per_model(self) -> Dict[int, np.ndarray]:
        if self._per_model is None:
            a = self.schedule.assignment
            self._per_model = {i: np.nonzero(a == i)[0]
                               for i in range(self.schedule.instance.m + 1)}
        return self._per_model

    @property
    def predicted_makespan(self) -> float:
        return self.schedule.makespan


@dataclasses.dataclass
class FleetPlan:
    """Legacy stacked planning result for one same-shape device batch."""
    assignment: np.ndarray    # (B, n) int64
    status: np.ndarray        # (B,) int: ST_OK / ST_FALLBACK / ST_INFEASIBLE
    solver: np.ndarray        # (B,) str
    plan_seconds: float


def _to_plan(sol: Solution) -> Plan:
    return Plan(schedule=sol.to_schedule(), plan_seconds=sol.plan_seconds,
                policy=sol.solver_name)


def _to_fleet_plan(sol: Solution) -> FleetPlan:
    return FleetPlan(assignment=sol.assignment,
                     status=np.asarray(sol.status),
                     solver=np.atleast_1d(sol.solver),
                     plan_seconds=sol.plan_seconds)


def plan(instance: OffloadInstance, *, policy: str = "auto",
         backend: str = "torch", device: DeviceLike = None) -> Plan:
    """Deprecated: use ``repro_torch.api.solve``."""
    _deprecated("plan", "api.solve(problem, policy=...)")
    _reject_bound_only(policy)
    return _to_plan(api.solve(Problem.from_instance(instance),
                              policy=policy, backend=backend,
                              device=device))


def plan_batch(instances: Union[InstanceBatch, Sequence[OffloadInstance]], *,
               policy: str = "auto", backend: str = "torch",
               device: DeviceLike = None) -> List[Plan]:
    """Deprecated: use ``repro_torch.api.solve_many`` (or ``solve`` on a
    `FleetProblem`)."""
    _deprecated("plan_batch", "api.solve_many(problems, policy=...)")
    _reject_bound_only(policy)
    if isinstance(instances, InstanceBatch):
        insts = [instances[b] for b in range(len(instances))]
    else:
        insts = list(instances)
    if not insts:
        return []
    sols = api.solve_many([Problem.from_instance(i) for i in insts],
                          policy=policy, backend=backend, device=device)
    return [_to_plan(s) for s in sols]


def plan_batch_arrays(batch: InstanceBatch, *, policy: str = "auto",
                      backend: str = "torch",
                      device: DeviceLike = None) -> FleetPlan:
    """Deprecated: use ``repro_torch.api.solve`` on a `FleetProblem`."""
    _deprecated("plan_batch_arrays",
                "api.solve(FleetProblem.from_batch(batch), policy=...)")
    _reject_bound_only(policy)
    return _to_fleet_plan(api.solve(FleetProblem.from_batch(batch),
                                    policy=policy, backend=backend,
                                    device=device))


def replan_without_es(instance: OffloadInstance, **kw) -> Plan:
    """Deprecated: use ``repro_torch.api.solve(..., es_disabled=True)``."""
    _deprecated("replan_without_es", "api.solve(problem, es_disabled=True)")
    return _to_plan(api.solve(Problem.from_instance(instance),
                              es_disabled=True, **kw))


def replan_without_es_batch(batch: InstanceBatch, *,
                            real_mask: Optional[np.ndarray] = None,
                            policy: str = "auto", backend: str = "torch",
                            device: DeviceLike = None) -> FleetPlan:
    """Deprecated: use ``repro_torch.api.solve`` on a `FleetProblem` with
    ``es_disabled=True``."""
    _deprecated("replan_without_es_batch",
                "api.solve(FleetProblem.from_batch(batch, real_mask), "
                "es_disabled=True)")
    _reject_bound_only(policy)
    fp = FleetProblem.from_batch(batch, real_mask=real_mask)
    return _to_fleet_plan(api.solve(fp, policy=policy, backend=backend,
                                    es_disabled=True, device=device))
