"""Core algorithms of the port: LP relaxation (batched simplex and the
NumPy oracle), AMR^2 rounding, AMDP, the dual scheduler, one-cell
admission and the greedy local fill.

Only names that do not shadow a submodule are exported here (`amr2` and
`amdp` stay the modules; import their functions from them)."""
from .dual import (dual_one_batch, dual_schedule, dual_schedule_batch,
                   dual_schedule_batch_arrays)
from .lp import solve_lp, solve_lp_batch

__all__ = ["dual_one_batch", "dual_schedule", "dual_schedule_batch",
           "dual_schedule_batch_arrays", "solve_lp", "solve_lp_batch"]
