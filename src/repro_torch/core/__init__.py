"""Core algorithms of the port: LP relaxation (batched simplex and the
NumPy oracle), AMR^2 rounding, AMDP, the dual scheduler, the chaos
fault model and ladder (`faults`), mobility's routing and admission
(`mobility`), and online hierarchical inference (`hi`).

Only names that do not shadow a submodule are exported here (`amr2` and
`amdp` stay the modules; import their functions from them)."""
from .dual import (dual_one_batch, dual_schedule, dual_schedule_batch,
                   dual_schedule_batch_arrays)
from .hi import (HILearnerState, HIModel, arm_grid, hi_period,
                 presample_stream, sample_confidence, validate_hi)
from .lp import simplex_batch_grad, solve_lp, solve_lp_batch
from .mobility import (MobilityModel, admit_mask_cells_np,
                       admit_mask_segmented, route_cells, validate_mobility)

__all__ = ["dual_one_batch", "dual_schedule", "dual_schedule_batch",
           "dual_schedule_batch_arrays", "solve_lp", "solve_lp_batch",
           "simplex_batch_grad", "HIModel", "HILearnerState", "arm_grid",
           "sample_confidence", "presample_stream", "hi_period",
           "validate_hi",
           "MobilityModel", "admit_mask_segmented", "admit_mask_cells_np",
           "route_cells", "validate_mobility"]
