"""The registry entries (port of `repro.api.solvers`): the paper's AMR^2
and AMDP, the Greedy-RRA baseline, the beyond-paper dual scheduler, the
mobility scenario's routed AMR^2, the online hierarchical-inference rules
(``hi_threshold``, ``hi_bandit``) and the LP bound behind the uniform
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
from ..core.hi import HILearnerState, HIModel, hi_period, validate_hi
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


class _HISolverBase:
    """Host front end of the online hierarchical-inference rules
    (`core.hi`): one period of per-sample decisions from an observed
    confidence matrix, the learner advanced when the caller feeds back the
    realized outcomes.  The decision needs no accuracy table: ``fleet.acc``
    is read only for the regret.  The engine's twin is
    `EngineParams.with_hi` + `rollout`; this entry is its single-period
    host mirror (``solve_fleet`` only)."""

    def _solve(self, fleet: FleetProblem, rule: str, *,
               confidence: np.ndarray, hi=None, state=None,
               observed_local=None, observed_es=None, t: int = 0,
               seed: int = 0, n_arms: int = 9, local_model: int = 0,
               device: DeviceLike = None) -> Solution:
        """Decide this period's assignments from ``confidence`` (B, n).

        ``hi`` is a `core.hi.HIModel` (default `HIModel.make()`),
        ``state`` the incoming `HILearnerState` (default: fresh at the
        model's ``theta0``).  With both ``observed_local`` and
        ``observed_es`` (B, n) bool outcomes the learner advances;
        without them the period is decide-only and the state comes back
        unchanged.  The state (tensors on ``device``, to feed back) and
        the served threshold (NumPy) ride on the solution as
        ``sol.hi_state`` / ``sol.hi_theta``.  EXP3 draws its arm uniforms
        for (seed, t)."""
        B, n = fleet.p_es.shape
        m = fleet.p_ed.shape[2]
        dev = resolve_device(device)
        hm = (hi if hi is not None else HIModel.make()).to(dev)
        # the host mirror gets confidences directly (it never samples the
        # calibration curves), so spread's class count is its own
        validate_hi(hm, n_devices=B, n_classes=hm.spread.shape[0],
                    n_models=m, rule=rule, stream="fold", n_arms=n_arms,
                    local_model=local_model)
        conf = np.asarray(confidence, np.float64)
        if conf.shape != (B, n):
            raise ValueError(
                f"confidence must be ({B}, {n}) to match the fleet; got "
                f"{conf.shape}")
        hst = (state.to(dev) if state is not None else HILearnerState.init(
            B, n_arms, hm.theta0, device=dev))
        have_obs = observed_local is not None and observed_es is not None
        cl = (np.asarray(observed_local, bool) if have_obs
              else np.zeros((B, n), bool))
        ces = (np.asarray(observed_es, bool) if have_obs
               else np.zeros((B, n), bool))
        acc_es = np.asarray(fleet.acc, np.float64)[:, m]
        offload, theta_t, new_hst, _reg = hi_period(
            rule, hm, hst, *(torch.as_tensor(a, device=dev)
                             for a in (conf, cl, ces, fleet.real_mask)),
            torch.as_tensor(acc_es, device=dev), t, (seed, t), n_arms)
        offload = offload.cpu().numpy()
        # phantoms follow the fleet convention: free ES columns
        assignment = np.where(offload | ~fleet.real_mask, m, local_model
                              ).astype(np.int64)
        sol = Solution(problem=fleet, assignment=assignment,
                       status=np.full(B, _STATUS_CODE["ok"], np.int64),
                       solver=np.full(B, self.info.name, dtype=object))
        # a decide-only call keeps the incoming state: the update above
        # ran on all-False placeholder outcomes
        sol.hi_state = new_hst if have_obs else hst
        sol.hi_theta = theta_t.cpu().numpy()
        return sol


@register_solver(
    "hi_threshold", batched=True, exact_on_identical=False,
    supports_es_disabled=False, online=True,
    description="online hierarchical inference: offload sample j iff "
                "conf_j < theta, theta learned in-stream by OGD "
                "(arXiv 2304.00891); engine twin: "
                "EngineParams.with_hi(rule='threshold')")
class HIThresholdSolver(_HISolverBase):
    def solve_fleet(self, fleet: FleetProblem, *, confidence: np.ndarray,
                    hi=None, state=None, observed_local=None,
                    observed_es=None, t: int = 0, seed: int = 0,
                    n_arms: int = 9, local_model: int = 0,
                    device: DeviceLike = None) -> Solution:
        return self._solve(
            fleet, "threshold", confidence=confidence, hi=hi, state=state,
            observed_local=observed_local, observed_es=observed_es, t=t,
            seed=seed, n_arms=n_arms, local_model=local_model,
            device=device)


@register_solver(
    "hi_bandit", batched=True, exact_on_identical=False,
    supports_es_disabled=False, online=True,
    description="online hierarchical inference: UCB over discretized "
                "thresholds (rule='ucb'; EXP3 via rule='exp3'); engine "
                "twin: EngineParams.with_hi(rule='ucb')")
class HIBanditSolver(_HISolverBase):
    """The rule is an argument of each call (the registry's one instance
    keeps no per-call state)."""

    def solve_fleet(self, fleet: FleetProblem, *,
                    confidence: np.ndarray, rule: str = "ucb", hi=None,
                    state=None, observed_local=None, observed_es=None,
                    t: int = 0, seed: int = 0, n_arms: int = 9,
                    local_model: int = 0,
                    device: DeviceLike = None) -> Solution:
        if rule not in ("ucb", "exp3"):
            raise ValueError(f"hi_bandit rule must be 'ucb' or 'exp3'; "
                             f"got {rule!r}")
        return self._solve(
            fleet, rule, confidence=confidence, hi=hi, state=state,
            observed_local=observed_local, observed_es=observed_es, t=t,
            seed=seed, n_arms=n_arms, local_model=local_model,
            device=device)


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
