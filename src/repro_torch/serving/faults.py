"""`repro_torch.serving.faults` — the serving-layer name for the fault
model and the degradation ladder (port of `repro.serving.faults`).

The implementation lives in `repro_torch.core.faults` (array work over the
same latency tables the planner prices, which also keeps `api.engine`,
which runs it inside the period, free of an import cycle through this
package).  This module re-exports it next to `FleetEngine`:

    from repro_torch.serving import faults
    fm = faults.FaultModel.make(loss_rate=0.1, straggler_prob=0.05)
    eng = FleetEngine.from_config(dataclasses.replace(cfg, faults=fm))

`FaultModel.none()` is the all-zero model; a rollout carrying it is
bit-identical to one with chaos disarmed.
"""
from ..core.faults import (FaultModel, FaultRealization, RealizedExecution,
                           greedy_local_fill, realize_execution,
                           sample_realization)

__all__ = [
    "FaultModel", "FaultRealization", "RealizedExecution",
    "sample_realization", "greedy_local_fill", "realize_execution",
]
