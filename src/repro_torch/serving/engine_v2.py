"""`repro_torch.serving.engine_v2` — the serving-layer name of the tensor
fleet engine (port of `repro.serving.engine_v2`).

The implementation lives in `repro_torch.api.engine`; this module
re-exports it under the serving namespace, next to `FleetEngine`:

    from repro_torch.serving import engine_v2
    params = engine_v2.EngineParams.from_config(cfg, horizon=64)
    state, metrics = engine_v2.rollout(engine_v2.init_state(params),
                                       params, periods=64)

A delegated `FleetEngine.run_period` runs the same period core, so the two
surfaces stay trajectory-identical.  The reference's traced admission
scan `admit_mask_jnp` is `admit_mask_pool` here.  The sharded names
(`fleet_mesh`, `shard`, `step_sharded`, `rollout_sharded`) run one
process per shard over a `torch.distributed` group:

    mesh = engine_v2.fleet_mesh()           # after init_process_group
    sstate, sparams = engine_v2.shard(state, params, mesh)
    local_state, metrics = engine_v2.rollout_sharded(sstate, sparams,
                                                     periods, mesh)
"""
from ..api.engine import (EngineParams, EngineState, PeriodMetrics,
                          TRACEABLE_POLICIES, fleet_mesh, init_state,
                          rollout, rollout_sharded, shard, step,
                          step_sharded)
from ..core.mobility import admit_mask_pool

__all__ = [
    "EngineParams", "EngineState", "PeriodMetrics", "TRACEABLE_POLICIES",
    "admit_mask_pool", "fleet_mesh", "init_state",
    "step", "rollout", "shard", "step_sharded", "rollout_sharded",
]
