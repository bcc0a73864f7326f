"""Core algorithms of the port: LP relaxation (batched simplex and the
NumPy oracle), AMR^2 rounding, AMDP, the dual scheduler, the chaos
fault model and ladder (`faults`), mobility's routing and admission
(`mobility`), and online hierarchical inference (`hi`).

The package exports the reference's names (`repro.core.__all__`) but
two: `amr2` and `amdp` stay the modules here, where the reference
shadows each module with its function (import the functions from the
modules: ``from repro_torch.core.amr2 import amr2``).  It also exports
the port's batched dual (`dual_one_batch`), the LP's implicit-gradient
entry (`simplex_batch_grad`) and the HI names."""
from .types import OffloadInstance, InstanceBatch, Schedule
from .problem import (Problem, FleetProblem, Solution,
                      SOLUTION_STATUS_NAMES, ES_DISABLED_SENTINEL)
from .lp import (solve_lp, solve_lp_batch, LPResult, BatchLPResult,
                 OPTIMAL, INFEASIBLE, UNBOUNDED, simplex_batch_grad)
from .amr2 import (amr2_batch, amr2_batch_arrays, solve_lp_relaxation,
                   fractional_jobs, solve_sub_ilp, algorithm2_case_tree,
                   build_lp_arrays, build_lp_arrays_batch, round_relaxation,
                   round_relaxation_batch)
from .amdp import amdp_batch, amdp_hetero_comm, solve_cckp
from .greedy import greedy_rra
from .oracle import brute_force
from .instances import (paper_instance, random_instance, identical_instance,
                        PAPER_ACC, PAPER_P_ED, PAPER_P_ES_PROC, PAPER_COMM)
from .dual import (dual_one_batch, dual_schedule, dual_schedule_batch,
                   dual_schedule_batch_arrays)
from .hi import (HILearnerState, HIModel, arm_grid, hi_period,
                 presample_stream, sample_confidence, validate_hi)
from .mobility import (MobilityModel, admit_mask_cells_np,
                       admit_mask_segmented, route_cells, validate_mobility)

__all__ = [
    "OffloadInstance", "InstanceBatch", "Schedule",
    "Problem", "FleetProblem", "Solution",
    "SOLUTION_STATUS_NAMES", "ES_DISABLED_SENTINEL",
    "solve_lp", "solve_lp_batch", "LPResult", "BatchLPResult",
    "OPTIMAL", "INFEASIBLE", "UNBOUNDED",
    "amr2_batch", "amr2_batch_arrays", "solve_lp_relaxation",
    "fractional_jobs", "solve_sub_ilp", "algorithm2_case_tree",
    "build_lp_arrays", "build_lp_arrays_batch", "round_relaxation",
    "round_relaxation_batch",
    "amdp_batch", "amdp_hetero_comm", "solve_cckp", "greedy_rra",
    "brute_force",
    "paper_instance", "random_instance", "identical_instance",
    "PAPER_ACC", "PAPER_P_ED", "PAPER_P_ES_PROC", "PAPER_COMM",
    "dual_schedule", "dual_schedule_batch", "dual_schedule_batch_arrays",
    "MobilityModel", "admit_mask_segmented", "admit_mask_cells_np",
    "route_cells", "validate_mobility",
    # the port's own
    "dual_one_batch", "simplex_batch_grad", "HIModel", "HILearnerState",
    "arm_grid", "sample_confidence", "presample_stream", "hi_period",
    "validate_hi",
]
