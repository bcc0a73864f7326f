"""Serving layer of the port: tier profiles, the period loop over a model
ladder, and the host fleet engine.

Ported: `profile` (`TierProfile`, `measure_latency`, `measure_profiles`,
`comm_time`, `roofline_profile`), `executor` (`execute`, the `EXEC_*`
status codes), `runtime` (`ServingRuntime`, `PeriodStats`,
`audit_profile`), `queue` (`RequestQueue`) and `fleet` (`FleetEngine`,
`make_fleet`, ...).  Not ported yet: the reference's `planner` shims,
`faults`, `hi` and `engine_v2` (ROADMAP §1 items 7 and 9).
"""
from .executor import (EXEC_DROPPED, EXEC_FALLBACK_LOCAL, EXEC_OK_ED,
                       EXEC_OK_ES, EXEC_STATUS_NAMES, ExecutionReport,
                       execute)
from .fleet import (DeviceSpec, EdgeServerPool, FleetEngine,
                    FleetPeriodStats, make_fleet, paper_style_profile,
                    roofline_style_profile)
from .profile import (TierProfile, comm_time, measure_latency,
                      measure_profiles, roofline_profile)
from .queue import RequestQueue
from .runtime import PeriodStats, ServingRuntime, audit_profile

__all__ = [
    "TierProfile", "measure_latency", "measure_profiles", "comm_time",
    "roofline_profile",
    "ExecutionReport", "execute", "EXEC_OK_ED", "EXEC_OK_ES",
    "EXEC_FALLBACK_LOCAL", "EXEC_DROPPED", "EXEC_STATUS_NAMES",
    "ServingRuntime", "PeriodStats", "audit_profile",
    "RequestQueue",
    "DeviceSpec", "EdgeServerPool", "FleetEngine", "FleetPeriodStats",
    "make_fleet", "paper_style_profile", "roofline_style_profile",
]
