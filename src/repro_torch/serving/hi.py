"""`repro_torch.serving.hi` — the serving-layer name for online
hierarchical inference (port of `repro.serving.hi`).

The implementation lives in `repro_torch.core.hi` (the confidence stream,
the learners and the regret accounting are tensor work with no serving
dependencies, which also keeps `api.engine`, which runs them inside the
period, free of an import cycle through this package).  This module
re-exports it next to `FleetEngine`:

    from repro_torch.serving import hi
    hm = hi.HIModel.from_profiles(profile.p_ed, offload_cost=0.15)
    eng = FleetEngine.from_config(
        dataclasses.replace(cfg, hi=hm, hi_rule="threshold"))

`HIModel.none()` is the null model; ``with_hi(None)`` disarms, and a
disarmed rollout is bit for bit one that never armed.
"""
from ..core.hi import (EXP3_GAMMA, HI_RULES, HI_STREAMS, HILearnerState,
                       HIModel, arm_grid, hi_period, presample_stream,
                       sample_confidence, validate_hi)

__all__ = [
    "HI_RULES", "HI_STREAMS", "EXP3_GAMMA",
    "HIModel", "HILearnerState",
    "arm_grid", "sample_confidence", "presample_stream", "hi_period",
    "validate_hi",
]
