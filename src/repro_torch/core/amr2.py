"""AMR^2 — Accuracy Maximization using LP-Relaxation and Rounding (paper
§IV), batched over a fleet of devices.

Port of `repro.core.amr2`.  A basic optimal solution of the relaxation
has at most two fractional jobs (Lemma 1); the rounding keeps the
integral part, best-fits one fractional job and solves the two-job
sub-ILP by (m+1)^2 enumeration, so the makespan stays within 2T
(Theorem 1).  Two paths, as in the reference:

* the engine's tensor path: `build_lp_arrays_torch` (counterpart of
  `build_lp_arrays_jnp`) and `round_relaxation_torch` (of
  `round_relaxation_jnp`), and the differentiable rollout's relaxed
  rounding, `soft_assignment_weights` and `straight_through_weights`;
* the front door's host path: `build_lp_arrays(_batch)`, the batched LP
  solve (`lp.solve_lp_batch`, on the card) and the NumPy rounding
  `round_relaxation_batch`, whose rare >2-fractional rows drop to the
  scalar `round_relaxation`; `amr2_batch_arrays` chains them, and
  `amr2_batch` returns the result as `Schedule`s;
* the scalar `amr2`: one instance through `solve_lp_relaxation` (the
  batched LP at B = 1, or the reference's NumPy oracle with
  ``backend="numpy"``) and `round_relaxation`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike
from .lp import INFEASIBLE, OPTIMAL, solve_lp, solve_lp_batch
from .types import InstanceBatch, OffloadInstance, Schedule

_FRAC_TOL = 1e-4

# status codes of the rounding, shared with `core.problem` (3 is the api's
# "bound" pseudo-status, never produced here)
ST_OK, ST_FALLBACK, ST_INFEASIBLE = 0, 1, 2
ST_UNSOLVED = 4
STATUS_NAMES = ("ok", "fallback", "infeasible", "bound", "unsolved")


def build_lp_arrays_torch(p_ed, p_es, acc, T):
    """Canonicalised LP of the relaxation: ``(A (B, R, C0), b (B, R),
    c_full (B, C0))`` with R = n + 2 rows (ED budget, ES budget, n
    assignment rows) and C0 = n(m+1) + 2 columns (variables + 2 slacks).
    ``b`` is nonnegative (T > 0, assignment rhs = 1), so no row flips are
    needed.  Counterpart of `repro.core.amr2.build_lp_arrays_jnp`."""
    B, n, m = p_ed.shape
    mp1 = m + 1
    nv = n * mp1
    dev, dtype = p_ed.device, p_ed.dtype
    ed = torch.zeros((B, n, mp1), dtype=dtype, device=dev)
    ed[:, :, :m] = p_ed
    es = torch.zeros((B, n, mp1), dtype=dtype, device=dev)
    es[:, :, m] = p_es
    eq = torch.kron(torch.eye(n, dtype=dtype, device=dev),
                    torch.ones((1, mp1), dtype=dtype, device=dev))
    slack = torch.zeros((n + 2, 2), dtype=dtype, device=dev)
    slack[0, 0] = slack[1, 1] = 1.0
    A = torch.cat([torch.stack([ed.reshape(B, nv), es.reshape(B, nv)], 1),
                   eq.expand(B, n, nv)], dim=1)
    A = torch.cat([A, slack.expand(B, n + 2, 2)], dim=2)
    Tb = torch.as_tensor(T, dtype=dtype, device=dev).reshape(-1, 1)
    Tb = Tb.expand(B, 1)
    b = torch.cat([Tb, Tb, torch.ones((B, n), dtype=dtype, device=dev)],
                  dim=1)
    c_full = torch.cat([-acc.repeat(1, n),
                        torch.zeros((B, 2), dtype=dtype, device=dev)], dim=1)
    return A.contiguous(), b, c_full


def round_relaxation_torch(p_ed, p_es, acc, T, xbar, status, *,
                     frac_tol: float = _FRAC_TOL):
    """Algorithm 1's rounding over a batch of LP relaxations ``xbar``
    (B, n, m+1) with LP ``status`` (B,).  Counterpart of
    `repro.core.amr2.round_relaxation_jnp`, case for case: first-max
    argmaxes, the one-fractional best-fit, the two-job sub-ILP
    enumeration, the infeasible / non-converged markings, and the
    >2-fractional fallback, whose two most fractional rows come from a
    stable descending sort.

    Returns ``(assignment (B, n) int32, sched_status (B,) int32,
    n_fractional (B,) int32)``."""
    B, n, mp1 = xbar.shape
    m = mp1 - 1
    dev, dtype = xbar.device, xbar.dtype
    bad = (status != OPTIMAL) & (status != INFEASIBLE)
    infeas = status == INFEASIBLE
    ok = ~infeas & ~bad

    assignment = xbar.argmax(dim=2).to(torch.int32)
    assignment = torch.where(infeas[:, None],
                             p_ed.argmin(dim=2).to(torch.int32), assignment)
    sched_status = torch.where(
        bad, ST_UNSOLVED,
        torch.where(infeas, ST_INFEASIBLE, ST_OK)).to(torch.int32)

    frac_rows = (((xbar > frac_tol) & (xbar < 1.0 - frac_tol)).any(dim=2)
                 & ok[:, None])
    fc = frac_rows.sum(dim=1)
    n_frac = torch.where(ok, torch.clamp_max(fc, 2), 0).to(torch.int32)

    # candidate job pair: first two fractional rows (fc <= 2) or the two
    # most fractional rows (fc > 2)
    lanes = torch.arange(B, device=dev)
    j1_first = frac_rows.to(torch.uint8).argmax(dim=1)
    masked = frac_rows.clone()
    masked[lanes, j1_first] = False
    j2_first = masked.to(torch.uint8).argmax(dim=1)
    fractionality = torch.where(frac_rows, 1.0 - xbar.amax(dim=2),
                                -torch.inf)
    top = torch.argsort(-fractionality, dim=1, stable=True)[:, :2]
    many = ok & (fc > 2)
    j1 = torch.where(many, top.amin(dim=1), j1_first)
    j2 = torch.where(many, top.amax(dim=1), j2_first)
    sched_status = torch.where(many, ST_FALLBACK, sched_status)

    Tb = torch.as_tensor(T, dtype=dtype, device=dev).reshape(-1).expand(B)
    ed_j1, ed_j2 = p_ed[lanes, j1], p_ed[lanes, j2]          # (B, m)
    es_j1, es_j2 = p_es[lanes, j1], p_es[lanes, j2]          # (B,)
    cols = torch.arange(n, device=dev)[None, :]

    # ---- one fractional job: best-fit (Algorithm 1 line 4) -------------
    one = ok & (fc == 1)
    feas1 = torch.cat([ed_j1 <= Tb[:, None], (es_j1 <= Tb)[:, None]], dim=1)
    val1 = torch.where(feas1, acc, -torch.inf)
    pick1 = val1.argmax(dim=1)
    none1 = ~feas1.any(dim=1)
    pick1 = torch.where(none1, ed_j1.argmin(dim=1), pick1)
    sched_status = torch.where(one & none1, ST_FALLBACK, sched_status)
    assignment = torch.where(one[:, None] & (cols == j1[:, None]),
                             pick1[:, None].to(torch.int32), assignment)

    # ---- two (or >2, truncated) fractional jobs: sub-ILP ---------------
    two = ok & (fc >= 2)
    zed = torch.zeros((B, 1), dtype=dtype, device=dev)
    zes = torch.zeros((B, m), dtype=dtype, device=dev)
    ed1 = torch.cat([ed_j1, zed], dim=1)                      # (B, m+1)
    ed2 = torch.cat([ed_j2, zed], dim=1)
    es1 = torch.cat([zes, es_j1[:, None]], dim=1)
    es2 = torch.cat([zes, es_j2[:, None]], dim=1)
    ed_load = ed1[:, :, None] + ed2[:, None, :]
    es_load = es1[:, :, None] + es2[:, None, :]
    feas2 = ((ed_load <= Tb[:, None, None] + 1e-12)
             & (es_load <= Tb[:, None, None] + 1e-12))
    val2 = acc[:, :, None] + acc[:, None, :]
    val2 = torch.where(feas2, val2, -torch.inf)
    flat = val2.reshape(B, -1).argmax(dim=1)
    i1, i2 = flat // mp1, flat % mp1
    none2 = ~feas2.reshape(B, -1).any(dim=1)
    i1 = torch.where(none2, ed_j1.argmin(dim=1), i1)
    i2 = torch.where(none2, ed_j2.argmin(dim=1), i2)
    sched_status = torch.where(two & none2, ST_FALLBACK, sched_status)
    assignment = torch.where(two[:, None] & (cols == j1[:, None]),
                             i1[:, None].to(torch.int32), assignment)
    assignment = torch.where(two[:, None] & (cols == j2[:, None]),
                             i2[:, None].to(torch.int32), assignment)
    return assignment, sched_status.to(torch.int32), n_frac


def soft_assignment_weights(xbar, *, tau: float = 0.25):
    """The smoothed twin of Algorithm 2's rounding: temperature-sharpened
    assignment weights (B, n, m+1) from the LP relaxation ``xbar``,
    ``softmax(log(clip(xbar, 1e-12, 1)) / tau)`` over the model axis (at
    tau = 1 the renormalized ``xbar``; as tau -> 0 the rounding's argmax
    on integral rows).  The clip is ``minimum(maximum(.))``, whose
    gradient splits at the bounds as the reference's ``jnp.clip`` does."""
    lo = torch.tensor(1e-12, dtype=xbar.dtype, device=xbar.device)
    hi = torch.tensor(1.0, dtype=xbar.dtype, device=xbar.device)
    lx = torch.log(torch.minimum(torch.maximum(xbar, lo), hi))
    return torch.softmax(lx / tau, dim=2)


def straight_through_weights(xbar, assignment, *, tau: float = 0.25):
    """Straight-through twin: the forward is the one-hot of the hard
    ``assignment`` (sub-ILP fix-ups included), the backward
    `soft_assignment_weights`' Jacobian."""
    soft = soft_assignment_weights(xbar, tau=tau)
    hard = torch.nn.functional.one_hot(assignment.long(),
                                       xbar.shape[2]).to(xbar.dtype)
    return soft + (hard - soft).detach()


# --------------------------------------------------------------------------
# host path: NumPy LP build and rounding around the batched LP solve
# --------------------------------------------------------------------------
def build_lp_arrays(inst: OffloadInstance):
    """LP relaxation of one instance: ``(c, A_ub, b_ub, A_eq, b_eq)`` with
    variables x[j, i] flattened j-major, i in 0..m (i == m is the ES)."""
    n, m = inst.n, inst.m
    mp1 = m + 1
    nv = n * mp1
    c = -np.tile(inst.acc, n)                      # maximize -> minimize -A
    A_ub = np.zeros((2, nv))
    for j in range(n):
        A_ub[0, j * mp1: j * mp1 + m] = inst.p_ed[j]   # (1): ED budget
        A_ub[1, j * mp1 + m] = inst.p_es[j]            # (2): ES budget
    b_ub = np.array([inst.T, inst.T])
    A_eq = np.zeros((n, nv))
    for j in range(n):
        A_eq[j, j * mp1: (j + 1) * mp1] = 1.0          # (3): one model each
    return c, A_ub, b_ub, A_eq, np.ones(n)


def build_lp_arrays_batch(batch: InstanceBatch):
    """Batched `build_lp_arrays`: (B, ...) arrays sharing (n, m)."""
    B, n, m = batch.p_ed.shape
    mp1 = m + 1
    nv = n * mp1
    c = -np.tile(batch.acc, (1, n))                      # (B, nv)
    ed_rows = np.zeros((B, n, mp1))
    ed_rows[:, :, :m] = batch.p_ed                       # constraint (1)
    es_rows = np.zeros((B, n, mp1))
    es_rows[:, :, m] = batch.p_es                        # constraint (2)
    A_ub = np.stack([ed_rows.reshape(B, nv), es_rows.reshape(B, nv)], axis=1)
    b_ub = np.stack([batch.T, batch.T], axis=1)
    A_eq = np.broadcast_to(np.kron(np.eye(n), np.ones(mp1)), (B, n, nv))
    b_eq = np.ones((B, n))                               # constraint (3)
    return c, A_ub, b_ub, A_eq, b_eq


def solve_lp_relaxation(inst: OffloadInstance, *, backend: str = "torch",
                        maxiter: Optional[int] = None,
                        warm_basis: Optional[np.ndarray] = None,
                        device: DeviceLike = None):
    """``(xbar (n, m+1), A*_LP, status, basis)`` of one instance: the
    batched LP at B = 1 on ``device``, or the sequential NumPy oracle with
    ``backend="numpy"``."""
    res = solve_lp(*build_lp_arrays(inst), maxiter=maxiter,
                   warm_basis=warm_basis, backend=backend, device=device)
    return res.x.reshape(inst.n, inst.m + 1), -res.fun, res.status, \
        res.basis


def amr2(inst: OffloadInstance, *, backend: str = "torch",
         frac_tol: float = _FRAC_TOL, maxiter: Optional[int] = None,
         warm_basis: Optional[np.ndarray] = None, on_error: str = "raise",
         device: DeviceLike = None) -> Schedule:
    """AMR^2 (Algorithm 1) on one instance: the LP relaxation
    (`solve_lp_relaxation`) and its rounding (`round_relaxation`)."""
    xbar, a_lp, status, _ = solve_lp_relaxation(
        inst, backend=backend, maxiter=maxiter, warm_basis=warm_basis,
        device=device)
    return round_relaxation(inst, xbar, a_lp, status, frac_tol=frac_tol,
                            on_error=on_error)


def fractional_jobs(xbar: np.ndarray, tol: float = _FRAC_TOL) -> np.ndarray:
    """Indices j whose row has any entry strictly inside (tol, 1-tol)."""
    frac = (xbar > tol) & (xbar < 1.0 - tol)
    return np.nonzero(frac.any(axis=1))[0]


def solve_sub_ilp(inst: OffloadInstance, j1: int, j2: int
                  ) -> Optional[Tuple[int, int]]:
    """Optimal assignment of two jobs under fresh budgets T on ED and ES,
    by enumeration of the (m+1) x (m+1) grid; None when even the two-job
    problem is infeasible."""
    m, T = inst.m, inst.T
    mp1 = m + 1
    ed1 = np.concatenate([inst.p_ed[j1], [0.0]])       # (m+1,)
    ed2 = np.concatenate([inst.p_ed[j2], [0.0]])
    es1 = np.concatenate([np.zeros(m), [inst.p_es[j1]]])
    es2 = np.concatenate([np.zeros(m), [inst.p_es[j2]]])
    ed_load = ed1[:, None] + ed2[None, :]              # (m+1, m+1)
    es_load = es1[:, None] + es2[None, :]
    feas = (ed_load <= T + 1e-12) & (es_load <= T + 1e-12)
    if not feas.any():
        return None
    val = inst.acc[:, None] + inst.acc[None, :]
    val = np.where(feas, val, -np.inf)
    flat = int(np.argmax(val))
    return flat // mp1, flat % mp1


def algorithm2_case_tree(inst: OffloadInstance, j1: int, j2: int
                         ) -> Optional[Tuple[int, int]]:
    """The paper's literal Algorithm 2 case analysis (cross-checks
    `solve_sub_ilp`).  Line 13's "models on the ES" reads "on the ED":
    with both p_{(m+1)j} > T neither job fits the ES budget."""
    m, T = inst.m, inst.T

    def best_fit_ed(j):
        ok = [i for i in range(m) if inst.p_ed[j, i] <= T]
        if not ok:
            return None
        return max(ok, key=lambda i: inst.acc[i])

    if inst.p_es[j1] <= T or inst.p_es[j2] <= T:           # line 2
        if inst.p_es[j1] + inst.p_es[j2] <= T:             # line 3
            return m, m
        b1, b2 = best_fit_ed(j1), best_fit_ed(j2)
        a1 = -np.inf if b1 is None else inst.acc[b1]
        a2 = -np.inf if b2 is None else inst.acc[b2]
        if a1 >= a2 and b1 is not None and inst.p_es[j2] <= T:  # line 6
            return b1, m
        if b2 is not None and inst.p_es[j1] <= T:               # line 9
            return m, b2
        # degenerate corners the paper's tree leaves implicit
        return solve_sub_ilp(inst, j1, j2)
    # line 12: both exceed the ES budget -> both on the ED (line 13)
    best = None
    for i1 in range(m):
        for i2 in range(m):
            if inst.p_ed[j1, i1] + inst.p_ed[j2, i2] <= T:
                v = inst.acc[i1] + inst.acc[i2]
                if best is None or v > best[0]:
                    best = (v, i1, i2)
    if best is None:
        return None
    return best[1], best[2]


def _best_fit_any(inst: OffloadInstance, j: int) -> Optional[int]:
    """argmax_{i in M} { a_i : p_{ij} <= T } (Algorithm 1, line 4)."""
    ok = [i for i in range(inst.m) if inst.p_ed[j, i] <= inst.T]
    if inst.p_es[j] <= inst.T:
        ok.append(inst.m)
    if not ok:
        return None
    return int(max(ok, key=lambda i: inst.acc[i]))


def round_relaxation(inst: OffloadInstance, xbar: np.ndarray, a_lp: float,
                     status: int, *, frac_tol: float = _FRAC_TOL,
                     solver: str = "amr2",
                     on_error: str = "raise") -> Schedule:
    """Algorithm 1 lines 2-11 on one LP relaxation.  A non-converged LP
    raises (``on_error="raise"``) or comes back as a best-effort schedule
    tagged "unsolved" (``on_error="mark"``)."""
    if status == INFEASIBLE:
        return Schedule(assignment=np.argmin(inst.p_ed, axis=1),
                        instance=inst, lp_accuracy=None, n_fractional=0,
                        status="infeasible", solver=solver)
    if status != OPTIMAL:
        if on_error != "mark":
            raise RuntimeError(
                f"LP relaxation did not converge (status={status})")
        return Schedule(assignment=np.argmax(xbar, axis=1).astype(np.int64),
                        instance=inst, lp_accuracy=None, n_fractional=0,
                        status="unsolved", solver=solver)

    frac = fractional_jobs(xbar, frac_tol)
    assignment = np.argmax(xbar, axis=1).astype(np.int64)
    sched_status = "ok"
    if len(frac) > 2:
        # Lemma 1 allows <= 2 for an exact basic optimum; numerically keep
        # the two most fractional rows and integer-round the rest
        fractionality = 1.0 - xbar[frac].max(axis=1)
        order = frac[np.argsort(-fractionality)]
        frac = np.sort(order[:2])
        sched_status = "fallback"
    if len(frac) == 1:
        j = int(frac[0])
        i = _best_fit_any(inst, j)
        if i is None:                       # P was integrally infeasible
            i = int(np.argmin(inst.p_ed[j]))
            sched_status = "fallback"
        assignment[j] = i
    elif len(frac) == 2:
        j1, j2 = int(frac[0]), int(frac[1])
        pair = solve_sub_ilp(inst, j1, j2)
        if pair is None:                    # P was integrally infeasible
            pair = (int(np.argmin(inst.p_ed[j1])),
                    int(np.argmin(inst.p_ed[j2])))
            sched_status = "fallback"
        assignment[j1], assignment[j2] = pair
    return Schedule(assignment=assignment, instance=inst, lp_accuracy=a_lp,
                    n_fractional=int(len(frac)), status=sched_status,
                    solver=solver)


def round_relaxation_batch(batch: InstanceBatch, xbar: np.ndarray,
                           status: np.ndarray, *,
                           frac_tol: float = _FRAC_TOL,
                           on_error: str = "raise"):
    """`round_relaxation` vectorized over a batch: the one-fractional
    best-fit and the two-job enumeration run as array ops, the rare
    >2-fractional rows on the scalar path; first-max argmaxes throughout,
    so assignments match the scalar code exactly.

    Returns ``(assignment (B, n) int64, sched_status (B,), n_fractional
    (B,))``."""
    B, n, mp1 = xbar.shape
    m = mp1 - 1
    status = np.asarray(status)
    bad = (status != OPTIMAL) & (status != INFEASIBLE)
    if bad.any() and on_error != "mark":
        raise RuntimeError(
            f"LP relaxation did not converge (status={int(status[bad][0])})")

    assignment = np.argmax(xbar, axis=2).astype(np.int64)
    sched_status = np.zeros(B, dtype=np.int64)
    n_frac = np.zeros(B, dtype=np.int64)
    sched_status[bad] = ST_UNSOLVED     # best-effort argmax, never rounded
    infeas = status == INFEASIBLE
    if infeas.any():
        assignment[infeas] = np.argmin(batch.p_ed[infeas], axis=2)
        sched_status[infeas] = ST_INFEASIBLE

    ok = ~infeas & ~bad
    frac_rows = (((xbar > frac_tol) & (xbar < 1.0 - frac_tol)).any(axis=2)
                 & ok[:, None])
    fc = frac_rows.sum(axis=1)
    n_frac[ok] = np.minimum(fc[ok], 2)

    for b in np.nonzero(ok & (fc > 2))[0]:    # numeric fallback, rare
        sched = round_relaxation(batch[b], xbar[b], 0.0, OPTIMAL,
                                 frac_tol=frac_tol)
        assignment[b] = sched.assignment
        sched_status[b] = STATUS_NAMES.index(sched.status)
        n_frac[b] = sched.n_fractional

    one = ok & (fc == 1)              # Algorithm 1 line 4
    if one.any():
        bs = np.nonzero(one)[0]
        js = np.argmax(frac_rows[bs], axis=1)
        Tb = batch.T[bs]
        feas = np.concatenate(
            [batch.p_ed[bs, js] <= Tb[:, None],
             (batch.p_es[bs, js] <= Tb)[:, None]], axis=1)   # (k, m+1)
        val = np.where(feas, batch.acc[bs], -np.inf)
        pick = np.argmax(val, axis=1)
        none = ~feas.any(axis=1)      # P integrally infeasible
        if none.any():
            pick[none] = np.argmin(batch.p_ed[bs[none], js[none]], axis=1)
            sched_status[bs[none]] = ST_FALLBACK
        assignment[bs, js] = pick

    two = ok & (fc == 2)              # Algorithm 2 by enumeration
    if two.any():
        bs = np.nonzero(two)[0]
        k = len(bs)
        j1 = np.argmax(frac_rows[bs], axis=1)
        masked = frac_rows[bs].copy()
        masked[np.arange(k), j1] = False
        j2 = np.argmax(masked, axis=1)
        Tb = batch.T[bs]
        zed = np.zeros((k, 1))
        zes = np.zeros((k, m))
        ed1 = np.concatenate([batch.p_ed[bs, j1], zed], axis=1)  # (k, m+1)
        ed2 = np.concatenate([batch.p_ed[bs, j2], zed], axis=1)
        es1 = np.concatenate([zes, batch.p_es[bs, j1][:, None]], axis=1)
        es2 = np.concatenate([zes, batch.p_es[bs, j2][:, None]], axis=1)
        ed_load = ed1[:, :, None] + ed2[:, None, :]           # (k, m+1, m+1)
        es_load = es1[:, :, None] + es2[:, None, :]
        feas = ((ed_load <= Tb[:, None, None] + 1e-12)
                & (es_load <= Tb[:, None, None] + 1e-12))
        val = batch.acc[bs][:, :, None] + batch.acc[bs][:, None, :]
        val = np.where(feas, val, -np.inf)
        flat = np.argmax(val.reshape(k, -1), axis=1)
        i1, i2 = flat // mp1, flat % mp1
        none = ~feas.any(axis=(1, 2))
        if none.any():
            i1[none] = np.argmin(batch.p_ed[bs[none], j1[none]], axis=1)
            i2[none] = np.argmin(batch.p_ed[bs[none], j2[none]], axis=1)
            sched_status[bs[none]] = ST_FALLBACK
        assignment[bs, j1] = i1
        assignment[bs, j2] = i2
    return assignment, sched_status, n_frac


def amr2_batch_arrays(batch: InstanceBatch, *, frac_tol: float = _FRAC_TOL,
                      maxiter: Optional[int] = None,
                      warm_basis: Optional[np.ndarray] = None,
                      on_error: str = "raise", method: str = "tableau",
                      device: DeviceLike = None):
    """Batched AMR^2 for the fleet front door: ONE batched LP solve on
    ``device`` (warm from ``warm_basis`` (B, R), -1 rows cold) and the
    NumPy rounding.  Returns ``(assignment (B, n), sched_status (B,),
    n_fractional (B,), lp_accuracy (B,), basis (B, R))``."""
    res = solve_lp_batch(*build_lp_arrays_batch(batch), maxiter=maxiter,
                         warm_basis=warm_basis, method=method,
                         device=device)
    B, n = batch.p_es.shape
    xbar = res.x.reshape(B, n, batch.m + 1)
    assignment, sched_status, n_frac = round_relaxation_batch(
        batch, xbar, res.status, frac_tol=frac_tol, on_error=on_error)
    return assignment, sched_status, n_frac, -res.fun, res.basis


def amr2_batch(batch: InstanceBatch, *, frac_tol: float = _FRAC_TOL,
               method: str = "tableau",
               device: DeviceLike = None) -> "list[Schedule]":
    """AMR^2 over B same-shape instances: one batched LP solve on
    ``device`` and the vectorized rounding (`amr2_batch_arrays`), as a
    list of `Schedule`s."""
    assignment, sched_status, n_frac, lp_acc, _ = amr2_batch_arrays(
        batch, frac_tol=frac_tol, method=method, device=device)
    return [Schedule(assignment=assignment[b], instance=batch[b],
                     lp_accuracy=(None if sched_status[b] in
                                  (ST_INFEASIBLE, ST_UNSOLVED)
                                  else float(lp_acc[b])),
                     n_fractional=int(n_frac[b]),
                     status=STATUS_NAMES[sched_status[b]], solver="amr2")
            for b in range(len(batch))]
