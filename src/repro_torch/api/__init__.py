"""Public API of the port.

One front door (`solve` / `solve_many`), one problem vocabulary
(`Problem`, `FleetProblem`), one result type (`Solution`) and a
capability-declaring registry (`register_solver`, `solvers`) — the port
of `repro.api` — plus the fleet engine (`engine`):

    >>> from repro_torch import api
    >>> sol = api.solve(fleet_problem)                  # auto: AMDP | AMR^2
    >>> sol = api.solve(fleet_problem, policy="dual")    # batched dual
    >>> sol = api.solve(fleet_problem, es_disabled=True)
    >>> sol = api.solve(fleet_problem, backend="numpy")  # the NumPy oracles
    >>> api.solver_names()
    ['amdp', 'amr2', 'dual', 'greedy', 'lp']

The differentiable rollout and online hierarchical inference ride on the
engine: ``params.with_differentiable(smooth_mode="soft")`` makes the
epoch's accuracy a function of the continuous knobs,

    >>> val, g = api.rollout_value_and_grad(engine.init_state(armed),
    ...                                     armed, periods)

and ``params.with_hi(HIModel.make(), rule="threshold")`` runs per-sample
confidence-gated offloading with the learner in the state.

Every entry point runs on the CUDA card unless given ``device="cpu"``.
"""
from ..core.problem import (ES_DISABLED_SENTINEL, SOLUTION_STATUS_NAMES,
                            ST_UNSOLVED, FleetProblem, Problem, Solution)
from ..core.hi import HILearnerState, HIModel
from . import engine
from .engine import (GRAD_LEAVES, combine_diff, partition_diff,
                     rollout_grad, rollout_value_and_grad)
from .front import batched_policies, solve, solve_many
from .registry import (Solver, SolverInfo, get_solver, register_solver,
                       solver_names, solver_table, solvers)

__all__ = [
    "Problem", "FleetProblem", "Solution",
    "SOLUTION_STATUS_NAMES", "ST_UNSOLVED", "ES_DISABLED_SENTINEL",
    "solve", "solve_many", "batched_policies",
    "Solver", "SolverInfo", "register_solver", "get_solver",
    "solver_names", "solvers", "solver_table",
    "engine",
    "GRAD_LEAVES", "rollout_grad", "rollout_value_and_grad",
    "partition_diff", "combine_diff",
    "HIModel", "HILearnerState",
]
