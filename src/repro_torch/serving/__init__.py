"""Serving layer of the port: tier profiles, the period loop over a model
ladder, and the fleet engine.

Ported: `profile` (`TierProfile`, `measure_latency`, `measure_profiles`,
`comm_time`, `roofline_profile`), `executor` (`execute`, the `EXEC_*`
status codes), `runtime` (`ServingRuntime`, `PeriodStats`,
`audit_profile`), `queue` (`RequestQueue`), `fleet` (`FleetEngine` and its
delegation to the tensor engine, `FleetConfig`, `UnsolvedPeriodError`,
`make_fleet`, ...), `faults` (the chaos fault model and degradation
ladder), `hi` (online hierarchical inference), `engine_v2` (the tensor
engine under the serving namespace) and the deprecated `planner` shims.
"""
from . import engine_v2, hi
from .hi import (HILearnerState, HIModel, arm_grid, hi_period,
                 presample_stream, sample_confidence)
from .faults import (FaultModel, FaultRealization, greedy_local_fill,
                     realize_execution, sample_realization)
from .executor import (EXEC_DROPPED, EXEC_FALLBACK_LOCAL, EXEC_OK_ED,
                       EXEC_OK_ES, EXEC_STATUS_NAMES, ExecutionReport,
                       execute)
from .fleet import (DeviceSpec, EdgeServerPool, FleetConfig, FleetEngine,
                    FleetPeriodStats, UnsolvedPeriodError, make_fleet,
                    paper_style_profile, roofline_style_profile)
from .planner import (FleetPlan, Plan, plan, plan_batch, plan_batch_arrays,
                      replan_without_es, replan_without_es_batch)
from .profile import (TierProfile, comm_time, measure_latency,
                      measure_profiles, roofline_profile)
from .queue import RequestQueue
from .runtime import PeriodStats, ServingRuntime, audit_profile

__all__ = [
    "TierProfile", "measure_latency", "measure_profiles", "comm_time",
    "roofline_profile",
    "FleetPlan", "Plan", "plan", "plan_batch", "plan_batch_arrays",
    "replan_without_es", "replan_without_es_batch",
    "ExecutionReport", "execute", "EXEC_OK_ED", "EXEC_OK_ES",
    "EXEC_FALLBACK_LOCAL", "EXEC_DROPPED", "EXEC_STATUS_NAMES",
    "ServingRuntime", "PeriodStats", "audit_profile",
    "RequestQueue",
    "DeviceSpec", "EdgeServerPool", "FleetConfig", "FleetEngine",
    "FleetPeriodStats", "UnsolvedPeriodError", "make_fleet",
    "paper_style_profile", "roofline_style_profile",
    "FaultModel", "FaultRealization", "sample_realization",
    "greedy_local_fill", "realize_execution",
    "HIModel", "HILearnerState", "arm_grid", "sample_confidence",
    "presample_stream", "hi_period",
    "engine_v2", "hi",
]
