"""Core algorithms of the port: LP relaxation (batched simplex and the
NumPy oracle), AMR^2 rounding, AMDP, the dual scheduler, the chaos
fault model and ladder (`faults`), and mobility's routing and admission
(`mobility`).

Only names that do not shadow a submodule are exported here (`amr2` and
`amdp` stay the modules; import their functions from them)."""
from .dual import (dual_one_batch, dual_schedule, dual_schedule_batch,
                   dual_schedule_batch_arrays)
from .lp import solve_lp, solve_lp_batch
from .mobility import (MobilityModel, admit_mask_cells_np,
                       admit_mask_segmented, route_cells, validate_mobility)

__all__ = ["dual_one_batch", "dual_schedule", "dual_schedule_batch",
           "dual_schedule_batch_arrays", "solve_lp", "solve_lp_batch",
           "MobilityModel", "admit_mask_segmented", "admit_mask_cells_np",
           "route_cells", "validate_mobility"]
