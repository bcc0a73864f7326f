"""`solve` / `solve_many`: the front door over the solver registry (port
of `repro.api.front`).

Dispatch rules:

  * ``policy="auto"`` — identical-job problems go to the exact AMDP,
    heterogeneous ones to AMR^2; a fleet is split by `identical_mask` and
    each side runs through its solver's batched path in one call.
  * ``policy=<name>`` — any registry entry (`solver_names()`).
    ``policy="amdp"`` on heterogeneous jobs falls back to AMR^2.
  * ``backend="torch"`` (the default, for fleets and single problems
    alike) runs each solver's batched path on ``device``: a single
    problem goes through it at B = 1.  This differs from the reference,
    whose single `Problem` defaults to its NumPy oracle.  A solver without
    a batched path (``greedy``) plans a fleet device by device through
    ``solve_one`` (the reference raises for it under ``"jax"``).
  * ``backend="numpy"`` is the reference's sequential oracle: every
    device through ``solve_one`` with the NumPy LP (`core.lp._solve_np`)
    and the NumPy dual (`core.dual.dual_schedule`).  It runs only when
    asked for by name; the reference's ``"jax"`` is refused, naming
    ``"torch"``.
  * ``es_disabled=True`` — plan with offloading made infeasible (uniform
    huge p_es on real jobs): the backpressure / ES-outage replan path.
    Identical-job detection then looks at the real jobs only.

This front door is a host boundary: problems and solutions are NumPy.  The
LP and the DP run on ``device`` — the CUDA card unless the caller names
another (`_device.resolve_device`).
"""
from __future__ import annotations

import inspect
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .._device import DeviceLike, resolve_device
from ..core.amdp import amdp_arrays, amdp_batch
from ..core.lp import _check_backend
from ..core.problem import (ST_UNSOLVED, FleetProblem, Problem, Solution)
from ..core.types import InstanceBatch, OffloadInstance
from . import solvers as _solvers
from .registry import get_solver, solvers

AnyProblem = Union[Problem, FleetProblem, OffloadInstance, InstanceBatch]


def batched_policies() -> "tuple[str, ...]":
    """Policies with a batched fleet path: ``auto`` plus every registry
    entry declaring ``batched=True``."""
    return ("auto",) + tuple(n for n, info in solvers().items()
                             if info.batched)


def _fallback_name(policy: str) -> str:
    """The solver of a fleet's non-identical rows: AMR^2 under
    ``auto``/``amdp``; any other named solver handles its whole fleet."""
    return "amr2" if policy in ("auto", "amdp") else policy


def _coerce(problem: AnyProblem) -> Union[Problem, FleetProblem]:
    if isinstance(problem, (Problem, FleetProblem)):
        return problem
    if isinstance(problem, OffloadInstance):
        return Problem.from_instance(problem)
    if isinstance(problem, InstanceBatch):
        return FleetProblem.from_batch(problem)
    raise TypeError(
        f"solve() wants a Problem/FleetProblem (or an OffloadInstance/"
        f"InstanceBatch); got {type(problem).__name__}")


def _filter_opts(fn: Callable, opts: Dict) -> Dict:
    """The options ``fn`` accepts: dispatch may reroute a problem to a
    solver other than the one ``policy`` names (amdp -> amr2, the auto
    split, the es-disabled rest path), and solver-specific options must
    not crash the rerouted call."""
    if not opts:
        return opts
    params = inspect.signature(fn).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD
           for p in params.values()):
        return opts
    return {k: v for k, v in opts.items() if k in params}


def _validate_opts(policy: str, opts: Dict) -> None:
    """Typo guard: an explicitly named policy must accept every option on
    at least one of its entry points (``auto`` options are best-effort)."""
    if policy == "auto":
        return
    solver = get_solver(policy)           # unknown names raise here
    if not opts:
        return
    accepted: set = set()
    for meth in ("solve_one", "solve_fleet"):
        fn = getattr(solver, meth, None)
        if fn is not None:
            accepted |= set(inspect.signature(fn).parameters)
    unknown = set(opts) - accepted
    if unknown:
        raise TypeError(
            f"solver {policy!r} does not accept option(s) "
            f"{sorted(unknown)}")


def _check_fleet_policy(policy: str, backend: str) -> None:
    """Refuse a backend the port does not have (the reference's "jax" is
    the port's "torch") and an unknown policy before any work is done."""
    _check_backend(backend)
    if policy != "auto":
        get_solver(policy)                # unknown names raise here


def _check_strict(sol: Solution, strict: bool) -> Solution:
    """Surface non-convergence (status "unsolved": LP iteration limit or
    unbounded) instead of silently returning a degraded plan."""
    n_bad = int((np.atleast_1d(sol.status) == ST_UNSOLVED).sum())
    if n_bad:
        msg = (f"{n_bad} problem(s) were not solved to optimality "
               f"(status 'unsolved': simplex iteration limit or unbounded "
               f"LP); raise maxiter, or pass strict=False to accept the "
               f"best-effort assignment")
        if strict:
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    return sol


def solve(problem: AnyProblem, *, policy: str = "auto",
          backend: str = "torch", es_disabled: bool = False,
          strict: bool = True, warm_start: Optional[np.ndarray] = None,
          device: DeviceLike = None, **opts) -> Solution:
    """Plan one `Problem` or a whole `FleetProblem` through the registry.

    ``warm_start`` feeds an LP-backed solver the previous period's optimal
    bases (`Solution.basis`); rows of -1 (or no longer valid) solve cold.
    ``strict`` True (default) raises when a solver fails to converge,
    False warns and returns the best-effort `Solution` tagged "unsolved".
    ``device`` is where the LP and the DP run (the card unless named);
    ``backend="numpy"`` plans device by device with the NumPy oracles.

    Returns a `Solution`; ``plan_seconds`` is the wall time of the call."""
    problem = _coerce(problem)
    _check_fleet_policy(policy, backend)
    dev = resolve_device(device)
    if warm_start is not None:
        opts["warm_start"] = np.asarray(warm_start)
    _validate_opts(policy, opts)
    opts.setdefault("on_error", "mark")   # the front door surfaces via strict
    if es_disabled and policy != "auto" \
            and not get_solver(policy).info.supports_es_disabled:
        raise ValueError(
            f"solver {policy!r} declares supports_es_disabled=False; "
            f"it cannot drive the backpressure/outage replan path")
    if isinstance(problem, FleetProblem):
        if es_disabled:
            sol = _solve_fleet_es_disabled(problem, policy, backend, dev,
                                           **opts)
        else:
            sol = _solve_fleet(problem, policy, backend, dev, **opts)
        return _check_strict(sol, strict)
    if es_disabled:
        problem = problem.es_disabled()
    return _check_strict(_solve_one(problem, policy, backend, dev, **opts),
                         strict)


# --------------------------------------------------------------------------
# single problem
# --------------------------------------------------------------------------
def _resolve_policy(problem: Problem, policy: str) -> str:
    if policy == "auto":
        policy = "amdp" if problem.is_identical() else "amr2"
    if policy == "amdp" and not problem.is_identical():
        policy = "amr2"                   # the DP's identical-jobs premise
    return policy


def _solve_one(problem: Problem, policy: str, backend: str, device,
               **opts) -> Solution:
    t0 = time.perf_counter()
    solver = get_solver(_resolve_policy(problem, policy))
    sol = solver.solve_one(problem, backend=backend, device=device,
                           **_filter_opts(solver.solve_one, opts))
    sol.plan_seconds = time.perf_counter() - t0
    return sol


# --------------------------------------------------------------------------
# fleet problem
# --------------------------------------------------------------------------
def _take_rows(opts: Dict, rows: np.ndarray) -> Dict:
    """Options of a row-subset dispatch: per-device option arrays (only
    ``warm_start``) are sliced to the subset's rows."""
    if opts.get("warm_start") is None:
        return opts
    sub = dict(opts)
    sub["warm_start"] = np.asarray(opts["warm_start"])[rows]
    return sub


class _FleetMerge:
    """Per-row results of several solver calls over one fleet."""

    def __init__(self, B: int, n: int):
        self.B = B
        self.assignment = np.zeros((B, n), dtype=np.int64)
        self.status = np.zeros(B, dtype=np.int64)
        self.solver = np.empty(B, dtype=object)
        self.basis: Optional[np.ndarray] = None
        self.lp_acc: Optional[np.ndarray] = None

    def put(self, rows, sub: Solution, tag) -> None:
        self.assignment[rows] = sub.assignment
        self.status[rows] = sub.status
        self.solver[rows] = tag
        if sub.basis is not None:
            if self.basis is None:   # -1 rows: devices another solver had
                self.basis = np.full((self.B, sub.basis.shape[1]), -1,
                                     dtype=np.int64)
            self.basis[rows] = sub.basis
        if sub.lp_accuracy is not None:
            if self.lp_acc is None:  # NaN rows: no LP bound for those
                self.lp_acc = np.full(self.B, np.nan)
            self.lp_acc[rows] = np.atleast_1d(
                np.asarray(sub.lp_accuracy, np.float64))

    def solution(self, problem: FleetProblem, t0: float) -> Solution:
        return Solution(problem=problem, assignment=self.assignment,
                        status=self.status, solver=self.solver,
                        basis=self.basis, lp_accuracy=self.lp_acc,
                        plan_seconds=time.perf_counter() - t0)


def _solve_fleet(fleet: FleetProblem, policy: str, backend: str, device,
                 **opts) -> Solution:
    t0 = time.perf_counter()
    B, n = fleet.p_es.shape
    out = _FleetMerge(B, n)
    if B == 0:
        return out.solution(fleet, t0)

    if backend == "numpy" or policy not in batched_policies():
        warm = opts.get("warm_start")
        for b in range(B):                # device by device
            o = opts
            if warm is not None:
                o = dict(opts)
                wb = np.asarray(warm)[b]
                if (wb >= 0).all():       # -1 rows: no basis for this one
                    o["warm_start"] = wb
                else:
                    del o["warm_start"]
            sol = _solve_one(fleet[b], policy, backend, device, **o)
            if sol.basis is not None:
                sol.basis = np.asarray(sol.basis)[None]
            out.put(np.array([b]), sol, sol.solver)
        return out.solution(fleet, t0)

    ident = (fleet.identical_mask() if policy in ("auto", "amdp")
             else np.zeros(B, dtype=bool))
    if ident.any():
        idxs = np.nonzero(ident)[0]
        amdp = get_solver("amdp")
        sub = amdp.solve_fleet(fleet.take(idxs), device=device,
                               **_filter_opts(amdp.solve_fleet,
                                              _take_rows(opts, idxs)))
        out.put(idxs, sub, "amdp")
    rest = np.nonzero(~ident)[0]
    if len(rest):
        name = _fallback_name(policy)
        solver = get_solver(name)
        sub = solver.solve_fleet(fleet.take(rest), device=device,
                                 **_filter_opts(solver.solve_fleet,
                                                _take_rows(opts, rest)))
        out.put(rest, sub, name)
        if len(rest) == B:
            # a solver's extras (routed's cell and link_factor, the HI
            # entries' learner state and threshold) survive when it
            # planned the whole fleet
            sol = out.solution(fleet, t0)
            for extra in ("cell", "link_factor", "hi_state", "hi_theta"):
                if hasattr(sub, extra):
                    setattr(sol, extra, getattr(sub, extra))
            return sol
    return out.solution(fleet, t0)


def _solve_fleet_es_disabled(fleet: FleetProblem, policy: str,
                             backend: str, device, **opts) -> Solution:
    """ONE batched ES-disabled solve for a sub-fleet (backpressure /
    outage): real jobs get the uniform huge ES time, phantom padding stays
    free, and under ``auto``/``amdp`` devices whose real jobs share
    processing times go to the exact DP on their stripped instances."""
    crippled = fleet.es_disabled()
    if backend == "numpy" or policy not in ("auto", "amdp"):
        return _solve_fleet(crippled, policy, backend, device, **opts)

    t0 = time.perf_counter()
    B, n = crippled.p_es.shape
    m = crippled.m
    mask = crippled.real_mask
    k = mask.sum(axis=1)
    first = np.argmax(mask, axis=1)                 # first real job index
    ref_row = crippled.p_ed[np.arange(B), first]    # (B, m)
    hetero = (~np.isclose(crippled.p_ed, ref_row[:, None, :], rtol=1e-9)
              ).any(axis=2) & mask
    ident = (k > 0) & ~hetero.any(axis=1)

    out = _FleetMerge(B, n)
    if ident.any():
        idxs = np.nonzero(ident)[0]
        dp_opts = {o: opts[o] for o in ("resolution",) if o in opts}
        stripped, infeasible = amdp_arrays(
            ref_row[idxs], crippled.p_es[idxs, first[idxs]],
            crippled.acc[idxs], crippled.T[idxs], k[idxs], device=device,
            **dp_opts)
        # real job j of a device is its rank-th real slot; phantoms: ES
        rank = np.cumsum(mask[idxs], axis=1) - 1
        padded = np.full((len(idxs), max(n, stripped.shape[1])), m,
                         np.int64)
        padded[:, :stripped.shape[1]] = stripped
        rows = np.where(mask[idxs], np.take_along_axis(
            padded, rank.clip(0), axis=1), m)
        out.assignment[idxs] = rows
        out.status[idxs] = np.where(infeasible,
                                    _solvers._STATUS_CODE["infeasible"],
                                    _solvers._STATUS_CODE["ok"])
        out.solver[idxs] = "amdp"
    rest = np.nonzero(~ident)[0]
    if len(rest):
        sub = _solve_fleet(crippled.take(rest), "amr2", "torch", device,
                           **_take_rows(opts, rest))
        out.put(rest, sub, np.atleast_1d(sub.solver))
    return out.solution(crippled, t0)


# --------------------------------------------------------------------------
# many single problems (mixed shapes)
# --------------------------------------------------------------------------
def solve_many(problems: Sequence[AnyProblem], *, policy: str = "auto",
               backend: str = "torch", strict: bool = True,
               warm_start: Optional[Sequence] = None,
               device: DeviceLike = None, **opts) -> List[Solution]:
    """Plan a sequence of (possibly mixed-shape) problems in as few solver
    calls as possible: identical-job problems batch through the DP
    whatever their shape, the rest group by (n, m) and run through their
    solver's batched path once per group.  Returns one `Solution` per
    problem, in input order; ``plan_seconds`` is the group's solve time
    shared among its members.

    ``warm_start`` is one basis or None per problem; each LP group stacks
    its members' bases (missing ones become cold -1 rows).
    ``backend="numpy"`` plans them one by one with the NumPy oracles."""
    probs = [_coerce(p) for p in problems]
    if any(isinstance(p, FleetProblem) for p in probs):
        raise TypeError("solve_many wants single problems; pass a "
                        "FleetProblem to solve() instead")
    if warm_start is not None and len(warm_start) != len(probs):
        raise ValueError(
            f"warm_start must align with problems: got {len(warm_start)} "
            f"bases for {len(probs)} problems")
    if not probs:
        return []
    dev = resolve_device(device)
    _validate_opts(policy, opts)
    opts.setdefault("on_error", "mark")
    _check_fleet_policy(policy, backend)

    def _done(sols: List[Solution]) -> List[Solution]:
        for s in sols:
            _check_strict(s, strict)
        return sols

    if backend == "numpy" or policy not in batched_policies():
        out = []
        for i, p in enumerate(probs):
            o = opts
            if warm_start is not None and warm_start[i] is not None:
                o = {**opts, "warm_start": np.asarray(warm_start[i])}
            out.append(_solve_one(p, policy, backend, dev, **o))
        return _done(out)

    sols: List[Solution] = [None] * len(probs)      # type: ignore
    amdp_idxs: List[int] = []
    groups: dict = {}
    for idx, p in enumerate(probs):
        if policy in ("auto", "amdp") and p.is_identical():
            amdp_idxs.append(idx)
        else:
            groups.setdefault((_fallback_name(policy), p.n, p.m),
                              []).append(idx)

    if amdp_idxs:
        t0 = time.perf_counter()
        scheds = amdp_batch([probs[i].to_instance() for i in amdp_idxs],
                            device=dev, **_filter_opts(amdp_batch, opts))
        dt = (time.perf_counter() - t0) / len(amdp_idxs)
        for i, sched in zip(amdp_idxs, scheds):
            sols[i] = Solution.from_schedule(sched, solver="amdp",
                                             plan_seconds=dt,
                                             problem=probs[i])

    for (name, n, m), idxs in groups.items():
        t0 = time.perf_counter()
        sub = FleetProblem.from_problems([probs[i] for i in idxs], pad_to=n)
        solver = get_solver(name)
        o = opts
        if warm_start is not None:
            bases = [warm_start[i] for i in idxs]
            have = [np.asarray(b) for b in bases if b is not None]
            if have:
                wb = np.full((len(idxs), have[0].shape[0]), -1,
                             dtype=np.int64)
                for row, b in enumerate(bases):
                    if b is not None:
                        wb[row] = np.asarray(b)
                o = {**opts, "warm_start": wb}
        fsol = solver.solve_fleet(sub, device=dev,
                                  **_filter_opts(solver.solve_fleet, o))
        dt = (time.perf_counter() - t0) / len(idxs)
        for row, i in enumerate(idxs):
            sols[i] = Solution(
                problem=probs[i], assignment=fsol.assignment[row],
                status=np.int64(fsol.status[row]), solver=name,
                plan_seconds=dt,
                lp_accuracy=(None if fsol.lp_accuracy is None
                             else fsol.lp_accuracy[row]),
                n_fractional=(None if fsol.n_fractional is None
                              else fsol.n_fractional[row]),
                basis=(None if fsol.basis is None else fsol.basis[row]))
    return _done(sols)
