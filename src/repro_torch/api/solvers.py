"""The registry entries (port of `repro.api.solvers`): the paper's AMR^2
and AMDP, the Greedy-RRA baseline, the beyond-paper dual scheduler, the
mobility scenario's routed AMR^2 and the LP bound behind the uniform
`Solver` protocol.

``solve_one`` plans one `Problem`; ``solve_fleet`` plans a same-shape
`FleetProblem` in one batched call.  What runs on the card — the LP
(`core.lp.solve_lp_batch`, through the simplex kernels), the DP
(`core.amdp`, through the CCKP kernel) and the dual's bisection
(`core.dual.dual_one_batch`) — runs on ``device``; the rounding and the
bookkeeping stay NumPy.  A single problem goes through the batched path at
B = 1 under ``backend="torch"``; ``backend="numpy"`` runs the reference's
sequential NumPy oracles instead (the LP's `_solve_np`, `dual_schedule`).
AMDP's DP and Greedy-RRA have one path, whatever the backend.  The
reference's ``impl=`` option has no counterpart: the device decides.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.amdp import amdp, amdp_arrays
from ..core.amr2 import (ST_INFEASIBLE, ST_UNSOLVED, amr2_batch_arrays,
                         build_lp_arrays_batch, round_relaxation,
                         solve_lp_relaxation)
from ..core.dual import dual_schedule, dual_schedule_batch_arrays
from ..core.greedy import greedy_rra
from ..core.lp import INFEASIBLE, OPTIMAL, solve_lp_batch
from ..core.mobility import route_cells, validate_mobility
from ..core.problem import (ES_DISABLED_SENTINEL, SOLUTION_STATUS_NAMES,
                            ST_BOUND, FleetProblem, Problem, Solution)
from .registry import register_solver

_STATUS_CODE = {name: code for code, name in enumerate(SOLUTION_STATUS_NAMES)}


@register_solver(
    "amr2", batched=True, exact_on_identical=False,
    supports_es_disabled=True, warm_start=True,
    description="LP-relax + round (paper Alg. 1–2): ≤2T makespan, "
                "≤2(a_max−a_min) accuracy gap")
class AMR2Solver:
    def solve_one(self, problem: Problem, *, backend: str = "torch",
                  frac_tol: float = 1e-4, maxiter: Optional[int] = None,
                  warm_start: Optional[np.ndarray] = None,
                  on_error: str = "raise",
                  device: DeviceLike = None) -> Solution:
        inst = problem.to_instance()
        xbar, a_lp, status, basis = solve_lp_relaxation(
            inst, backend=backend, maxiter=maxiter, warm_basis=warm_start,
            device=device)
        sched = round_relaxation(inst, xbar, a_lp, status,
                                 frac_tol=frac_tol, on_error=on_error)
        sol = Solution.from_schedule(sched, solver="amr2", problem=problem)
        sol.basis = np.asarray(basis, np.int64)
        return sol

    def solve_fleet(self, fleet: FleetProblem, *, frac_tol: float = 1e-4,
                    maxiter: Optional[int] = None,
                    warm_start: Optional[np.ndarray] = None,
                    on_error: str = "raise",
                    device: DeviceLike = None) -> Solution:
        B = len(fleet)
        assign, status, n_frac, lp_acc, basis = amr2_batch_arrays(
            fleet.to_batch(), frac_tol=frac_tol, maxiter=maxiter,
            warm_basis=warm_start, on_error=on_error, device=device)
        lp_acc = np.array(lp_acc, np.float64)
        lp_acc[(status == ST_INFEASIBLE) | (status == ST_UNSOLVED)] = np.nan
        return Solution(problem=fleet, assignment=assign, status=status,
                        solver=np.full(B, "amr2", dtype=object),
                        lp_accuracy=lp_acc, n_fractional=n_frac,
                        basis=np.asarray(basis, np.int64))


@register_solver(
    "routed", batched=True, exact_on_identical=False,
    supports_es_disabled=True, warm_start=True,
    description="geometry-aware amr2: route each lane to its best covered "
                "cell, price ES by the link factor, then delegate "
                "(core.mobility; uncovered lanes plan local-only)")
class RoutedSolver:
    """Multi-cell front end over `AMR2Solver`, the host twin of the
    engine's routing pass.  Each lane gets a serving cell from its
    position (`core.mobility.route_cells` at zero cell load: nearest or
    least response time under the coverage radius), its ES column is
    scaled by that cell's link factor, and uncovered lanes get the
    ES-disabled sentinel (local-only plans).  The LP is amr2 unchanged, so
    its guarantees hold per lane under the routed prices.  The solution
    reports against the caller's problem, with ``cell`` and
    ``link_factor`` attached."""

    def solve_fleet(self, fleet: FleetProblem, *, positions: np.ndarray,
                    mobility, routing: str = "nearest",
                    frac_tol: float = 1e-4,
                    maxiter: Optional[int] = None,
                    warm_start: Optional[np.ndarray] = None,
                    on_error: str = "raise",
                    device: DeviceLike = None) -> Solution:
        B = len(fleet)
        pos = np.asarray(positions, np.float64)
        if pos.shape != (B, 2):
            raise ValueError(
                f"positions must be ({B}, 2) to match the fleet; got "
                f"{pos.shape}")
        validate_mobility(mobility, n_devices=B,
                          n_servers=mobility.n_cells,    # 1 server / cell
                          mode="replay", routing=routing)
        dev = resolve_device(device)
        cell, covered, link_factor = (
            t.cpu().numpy() for t in route_cells(
                torch.as_tensor(pos, device=dev), mobility.to(dev),
                torch.zeros(mobility.n_cells, dtype=torch.float64,
                            device=dev),
                routing))
        p_es = fleet.p_es * link_factor[:, None]
        p_es = np.where((~covered[:, None]) & fleet.real_mask,
                        ES_DISABLED_SENTINEL, p_es)
        routed = FleetProblem(p_ed=fleet.p_ed, p_es=p_es, acc=fleet.acc,
                              T=fleet.T, real_mask=fleet.real_mask)
        sol = AMR2Solver().solve_fleet(
            routed, frac_tol=frac_tol, maxiter=maxiter,
            warm_start=warm_start, on_error=on_error, device=dev)
        sol.problem = fleet
        sol.solver = np.full(B, "routed", dtype=object)
        sol.cell = cell.astype(np.int64)
        sol.link_factor = link_factor
        return sol


@register_solver(
    "amdp", batched=True, exact_on_identical=True,
    supports_es_disabled=True,
    description="exact pseudo-polynomial DP for identical jobs (paper §VI)")
class AMDPSolver:
    def solve_one(self, problem: Problem, *, backend: str = "torch",
                  resolution: float = 1e-3,
                  device: DeviceLike = None) -> Solution:
        del backend                       # the DP runs the same on both
        sched = amdp(problem.to_instance(), resolution=resolution,
                     device=device)
        return Solution.from_schedule(sched, solver="amdp", problem=problem)

    def solve_fleet(self, fleet: FleetProblem, *, resolution: float = 1e-3,
                    device: DeviceLike = None) -> Solution:
        B, n = len(fleet), fleet.n
        if not fleet.identical_mask().all():
            raise ValueError("amdp requires identical jobs on every device; "
                             "use policy='auto' to route the rest to amr2")
        if B == 0 or n == 0:
            assignment = np.zeros((B, n), np.int64)
            infeasible = np.zeros(B, bool)
        else:
            assignment, infeasible = amdp_arrays(
                fleet.p_ed[:, 0, :], fleet.p_es[:, 0], fleet.acc, fleet.T,
                np.full(B, n), resolution=resolution, device=device)
        status = np.where(infeasible, _STATUS_CODE["infeasible"],
                          _STATUS_CODE["ok"]).astype(np.int64)
        return Solution(problem=fleet, assignment=assignment, status=status,
                        solver=np.full(B, "amdp", dtype=object))


@register_solver(
    "dual", batched=True, exact_on_identical=False,
    supports_es_disabled=True,
    description="beyond-paper Lagrangian-dual bisection + density-greedy "
                "knapsack (no 2T guarantee; ~1% gap, near-free)")
class DualSolver:
    def solve_one(self, problem: Problem, *, backend: str = "torch",
                  iters: int = 40, device: DeviceLike = None) -> Solution:
        if backend == "numpy":
            sched = dual_schedule(problem.to_instance(), iters=iters)
            return Solution.from_schedule(sched, solver="dual",
                                          problem=problem)
        # B = 1, unpadded: phantom slots would change the bisection's
        # bracket (min p_ed) and so the plan
        sol = self.solve_fleet(
            FleetProblem.from_problems([problem], pad_to=problem.n),
            iters=iters, device=device)
        return Solution(problem=problem, assignment=sol.assignment[0],
                        status=np.int64(sol.status[0]), solver="dual")

    def solve_fleet(self, fleet: FleetProblem, *, iters: int = 40,
                    device: DeviceLike = None) -> Solution:
        B = len(fleet)
        assign, status = dual_schedule_batch_arrays(
            fleet.to_batch(), iters=iters, device=device)
        return Solution(problem=fleet, assignment=assign, status=status,
                        solver=np.full(B, "dual", dtype=object))


@register_solver(
    "greedy", batched=False, exact_on_identical=False,
    supports_es_disabled=True,
    description="Greedy-RRA baseline (paper §VII): O(n), may violate T")
class GreedySolver:
    def solve_one(self, problem: Problem, *, backend: str = "torch",
                  device: DeviceLike = None) -> Solution:
        del backend, device               # host-only: O(n) per device
        sched = greedy_rra(problem.to_instance())
        return Solution.from_schedule(sched, solver="greedy",
                                      problem=problem)


@register_solver(
    "lp", batched=True, exact_on_identical=False,
    supports_es_disabled=False, bound_only=True, warm_start=True,
    description="LP relaxation A*_LP upper bound; assignment is the argmax "
                "of a possibly fractional optimum")
class LPBoundSolver:
    """Bound-only entry: the integral accuracy is bounded above by
    ``lp_accuracy``; the argmax assignment need not fit the budgets."""

    def solve_one(self, problem: Problem, *, backend: str = "torch",
                  maxiter: Optional[int] = None,
                  warm_start: Optional[np.ndarray] = None,
                  on_error: str = "raise",
                  device: DeviceLike = None) -> Solution:
        xbar, a_lp, status, basis = solve_lp_relaxation(
            problem.to_instance(), backend=backend, maxiter=maxiter,
            warm_basis=warm_start, device=device)
        if status == INFEASIBLE:
            return Solution(problem=problem,
                            assignment=np.argmin(problem.p_ed, axis=1),
                            status=np.int64(_STATUS_CODE["infeasible"]),
                            solver="lp")
        if status != OPTIMAL:
            if on_error != "mark":
                raise RuntimeError(f"LP relaxation failed (status={status})")
            return Solution(
                problem=problem,
                assignment=np.argmax(xbar, axis=1).astype(np.int64),
                status=np.int64(ST_UNSOLVED), solver="lp")
        return Solution(problem=problem,
                        assignment=np.argmax(xbar, axis=1).astype(np.int64),
                        status=np.int64(ST_BOUND), solver="lp",
                        lp_accuracy=np.float64(a_lp),
                        basis=np.asarray(basis, np.int64))

    def solve_fleet(self, fleet: FleetProblem, *,
                    maxiter: Optional[int] = None,
                    warm_start: Optional[np.ndarray] = None,
                    method: str = "tableau", on_error: str = "raise",
                    device: DeviceLike = None) -> Solution:
        B = len(fleet)
        res = solve_lp_batch(*build_lp_arrays_batch(fleet.to_batch()),
                             maxiter=maxiter, warm_basis=warm_start,
                             method=method, device=device)
        xbar = res.x.reshape(B, fleet.n, fleet.m + 1)
        st = res.status
        bad = (st != OPTIMAL) & (st != INFEASIBLE)
        if bad.any() and on_error != "mark":
            raise RuntimeError(
                f"LP relaxation failed (status={int(st[bad][0])})")
        assignment = np.argmax(xbar, axis=2).astype(np.int64)
        infeas = st == INFEASIBLE
        if infeas.any():
            assignment[infeas] = np.argmin(fleet.p_ed[infeas], axis=2)
        status = np.where(infeas, _STATUS_CODE["infeasible"],
                          ST_BOUND).astype(np.int64)
        status[bad] = ST_UNSOLVED
        lp_acc = np.asarray(-res.fun, dtype=np.float64).copy()
        lp_acc[infeas | bad] = np.nan
        return Solution(problem=fleet, assignment=assignment, status=status,
                        solver=np.full(B, "lp", dtype=object),
                        lp_accuracy=lp_acc, basis=res.basis)
