"""Batched two-phase primal simplex over float64 tensors.

Port of the engine path of `repro.core.lp`: `simplex_batch_core` with its
dense-tableau (`_two_phase_virtual` -> `_phase_batched`) and reduced
revised (`_revised_core` -> `_revised_two_phase` -> `_revised_phase`)
methods, the warm start (`_warm_init`, `_warm_init_reduced`,
`_batched_inverse`), the iteration budget (`_bucket_maxiter`) and
`simplex_batch_grad`, the same solve with an implicit-function gradient
(a `torch.autograd.Function`).

Problem form (canonicalised, ``b >= 0``): minimize ``c @ x`` subject to
``A x == b``, ``x >= 0``, batched over a leading lane axis.  Every
artificial is virtual — a basis LABEL ``>= C0`` whose column is never
materialized — so a cold lane starts with every row basic on its own
artificial and phase 1 minimizes their sum; a warm lane factors last
period's basis and repairs infeasible rows with virtual artificials.

Anti-cycling: Dantzig's entering rule until ``bland_after`` consecutive
degenerate pivots, then Bland's smallest index until a non-degenerate
pivot; the leaving row is the smallest basis label among min-ratio ties,
with basic artificials at level 0 driven out first.

The reference runs each phase as a `lax.while_loop`; here it is a Python
loop whose condition is read on the host once per pivot.  The pivot body
is `kernels.simplex_pivot.ops` — the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor.  The LP is float64 only: a float32
simplex cycles until ``maxiter``.

The host entry points `solve_lp_batch` and `solve_lp` (port of the
reference's) take NumPy LPs in standard form, canonicalise them
(`_canonicalize_batch`), run `simplex_batch_core` on ``device`` and bring
NumPy results back.  With ``backend="numpy"`` they run the reference's
sequential NumPy oracle instead (`_canonicalize`, `_solve_np`,
`_warm_np`, `_phase_np`): the same algorithm on one instance at a time in
host float64, with the artificial columns materialized — the oracle the
batched path is held to, run only when a caller names it.

Statuses: 0 optimal, 1 iteration limit, 2 infeasible, 3 unbounded.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..kernels.simplex_pivot import ops as pivot_ops
from ..kernels.simplex_pivot.ref import (INT32_MAX, kkt_vjp_ref,
                                        price_reduced_ref)
from .types import next_pow2

OPTIMAL, ITERATION_LIMIT, INFEASIBLE, UNBOUNDED = 0, 1, 2, 3

# Consecutive degenerate pivots tolerated before the entering rule switches
# from Dantzig to Bland.
BLAND_AFTER = 8

# warm-start accept thresholds (float64): primal feasibility of the
# factored basis and the factor's residual
_FEAS_TOL, _RESID_TOL = 1e-9, 1e-6


def _bucket_maxiter(maxiter: int) -> int:
    """Round a shape-derived default maxiter up to a power of two (the
    reference's trace-reuse bucketing; kept so budgets match)."""
    return next_pow2(maxiter)


def _running(status, it, maxiter: int) -> bool:
    """The phase loop's condition, read on the host (one sync per pivot)."""
    return bool(((status == ITERATION_LIMIT) & (it < maxiter)).any())


def _phase_batched(tabs, bases, art_start: int, *, maxiter: int, tol: float,
                   bland_after: int, it0=None):
    """Masked batched simplex phase over stacked tableaus (B, R+1, C+1).

    Every iteration pivots all still-active lanes at once through
    `ops.pivot_update`.  ``tabs`` is updated in place; ``it0`` (B,) int32
    seeds the per-lane iteration counters (one maxiter budget across both
    phases).  Returns ``(tabs, bases, it, status)``."""
    B, R1, C1 = tabs.shape
    R, C = R1 - 1, C1 - 1
    dev = tabs.device
    cols = torch.arange(C, device=dev)
    rows = torch.arange(R, device=dev)
    it = (torch.zeros(B, dtype=torch.int32, device=dev) if it0 is None
          else it0.clone())
    status = torch.full((B,), ITERATION_LIMIT, dtype=torch.int32,
                        device=dev)
    degen = torch.zeros(B, dtype=torch.int32, device=dev)
    while _running(status, it, maxiter):
        rc = tabs[:, -1, :C]
        enter_mask = (rc < -tol) & (cols[None, :] < art_start)
        has_enter = enter_mask.any(dim=1)
        running = status == ITERATION_LIMIT
        status = torch.where(running & ~has_enter, OPTIMAL, status)
        active = running & has_enter & (it < maxiter)

        score = torch.where(enter_mask, rc, torch.inf)
        j_dantzig = score.argmin(dim=1)
        j_bland = enter_mask.to(torch.uint8).argmax(dim=1)
        j = torch.where(degen >= bland_after, j_bland, j_dantzig)

        col = torch.gather(tabs[:, :R, :], 2,
                           j[:, None, None].expand(B, R, 1))[..., 0]
        rhsv = tabs[:, :R, -1]
        pos = col > tol
        ratio = torch.where(pos, rhsv / torch.where(pos, col, 1.0),
                            torch.inf)
        art_basic = (bases >= art_start) & (col.abs() > tol) & (rhsv <= tol)
        ratio = torch.where(art_basic, 0.0, ratio)
        unbounded = ~(ratio < torch.inf).any(dim=1)
        rmin = ratio.amin(dim=1)
        tie = ratio <= (rmin + torch.clamp_min(rmin.abs() * 1e-9,
                                               1e-12))[:, None]
        r = torch.where(tie, bases, INT32_MAX).argmin(dim=1)

        do_pivot = active & ~unbounded
        j32 = j.to(torch.int32)
        pivot_ops.pivot_update(tabs, r.to(torch.int32), j32, do_pivot)
        is_r = rows[None, :] == r[:, None]
        bases = torch.where(do_pivot[:, None] & is_r, j32[:, None], bases)
        status = torch.where(active & unbounded, UNBOUNDED, status)
        degen = torch.where(do_pivot,
                            torch.where(rmin <= tol, degen + 1, 0), degen)
        it = it + active.to(torch.int32)
    rc = tabs[:, -1, :C]
    done = ~((rc < -tol) & (cols[None, :] < art_start)).any(dim=1)
    status = torch.where((status == ITERATION_LIMIT) & done, OPTIMAL,
                         status)
    return tabs, bases, it, status


def _batched_inverse(Bmat):
    """Gauss-Jordan inverse with partial pivoting across the lane axis:
    (B, R, R) -> (B, R, R), the reference's elimination step for step (so
    warm-start repair makes the same decisions).  Singular lanes come out
    inf/nan and are caught by the caller's residual check."""
    B, R, _ = Bmat.shape
    dev, dtype = Bmat.device, Bmat.dtype
    eye = torch.eye(R, dtype=dtype, device=dev).expand(B, R, R)
    aug = torch.cat([Bmat, eye], dim=2)                 # (B, R, 2R)
    rows = torch.arange(R, device=dev)
    lanes = torch.arange(B, device=dev)
    for k in range(R):
        cand = torch.where(rows[None, :] >= k, aug[:, :, k].abs(), -1.0)
        p = cand.argmax(dim=1)                          # pivot row
        row_p = aug[lanes, p]
        row_k = aug[:, k, :]
        is_k = rows[None, :] == k
        is_p = rows[None, :] == p[:, None]
        aug = torch.where(is_k[:, :, None], row_p[:, None, :], aug)
        aug = torch.where((is_p & ~is_k)[:, :, None], row_k[:, None, :], aug)
        piv_row = aug[:, k, :] / aug[:, k, k:k + 1]
        new = torch.addcmul(aug, aug[:, :, k, None], piv_row[:, None, :],
                            value=-1)          # one rounding, like XLA's FMA
        aug = torch.where(is_k[:, :, None], piv_row[:, None, :], new)
    return aug[:, :, R:]


def _warm_init_reduced(A, b, basis0):
    """Factor each lane's previous basis and repair primal infeasibility in
    basis-inverse form: violated rows are sign-flipped (on the Binv row)
    and handed a virtual artificial (label C0 + row).

    Returns ``(Binv (B, R, R), rhs (B, R), bas (B, R) int32, ok (B,))``;
    lanes with ``ok`` False (a -1 / out-of-range basis row, or a singular
    or ill-conditioned factor) hold garbage and must run cold."""
    B, R, C0 = A.shape
    dev, dtype = A.device, A.dtype
    bas = basis0.clamp(0, C0 - 1).to(torch.int32)
    in_range = (basis0 >= 0).all(dim=1) & (basis0 < C0).all(dim=1)

    Bmat = torch.gather(A, 2, bas.long()[:, None, :].expand(B, R, R))
    Binv = _batched_inverse(Bmat)
    eye = torch.eye(R, dtype=dtype, device=dev)
    resid = (Bmat @ Binv - eye).abs().amax(dim=(1, 2))
    rhs = (Binv @ b[..., None])[..., 0]
    ok = in_range & torch.isfinite(resid) & (resid < _RESID_TOL)

    flip = rhs < -_FEAS_TOL
    sgn = torch.where(flip, -1.0, 1.0).to(dtype)
    Binv = Binv * sgn[:, :, None]
    rhs = torch.clamp_min(rhs * sgn, 0.0)   # clamp -feas_tol..0 dust to 0
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    bas = torch.where(flip, C0 + rows[None, :], bas)
    return Binv, rhs, bas.to(torch.int32), ok


def _warm_init(A, b, basis0):
    """`_warm_init_reduced` expanded to dense-tableau form: the repaired
    factor prices the full tableau (``tabA = Binv @ A``).  Returns
    ``(tabA (B, R, C0), rhs, bas, ok)``."""
    Binv, rhs, bas, ok = _warm_init_reduced(A, b, basis0)
    return Binv @ A, rhs, bas, ok


def _two_phase_virtual(tabA, rhs, bas, b, c_full, *, nv, maxiter, tol,
                       bland_after, lane_mask=None):
    """Both simplex phases over virtual-artificial tableaus: build the
    (B, R+1, C0+1) stack, minimize the sum of artificial-basis rows, swap
    in the real objective priced over the resulting basis, run phase 2,
    and scatter the solution out.  ``lane_mask`` False zeroes a lane's
    tableau (no entering column, 0 pivots, garbage x).

    Returns ``(x (B, nv), fun, status, niter, bases)``."""
    B, R, C0 = tabA.shape
    dev, dtype = tabA.device, tabA.dtype
    tabs = torch.zeros((B, R + 1, C0 + 1), dtype=dtype, device=dev)
    tabs[:, :R, :C0] = tabA
    tabs[:, :R, -1] = rhs
    art_row = (bas >= C0).to(dtype)
    tabs[:, -1, :] = -torch.einsum("br,brc->bc", art_row, tabs[:, :R, :])
    if lane_mask is not None:
        tabs = torch.where(lane_mask[:, None, None], tabs, 0.0)

    tabs, bases, it1, status1 = _phase_batched(
        tabs, bas, C0, maxiter=maxiter, tol=tol, bland_after=bland_after)
    phase1_obj = tabs[:, -1, -1]          # = -(sum of basic artificials)
    infeasible = phase1_obj < -max(tol, 1e-5) * (1.0 + b.abs().sum(dim=1))

    # phase 2: swap in the real objective, priced out over the basis
    # (virtual artificial labels price at cost 0)
    obj = torch.zeros((B, C0 + 1), dtype=dtype, device=dev)
    obj[:, :C0] = c_full
    cb = torch.where(bases < C0,
                     torch.gather(obj[:, :C0], 1,
                                  bases.long().clamp(0, C0 - 1)), 0.0)
    obj = obj - torch.einsum("br,brc->bc", cb, tabs[:, :R, :])
    if lane_mask is not None:
        obj = torch.where(lane_mask[:, None], obj, 0.0)
    tabs[:, -1, :] = obj
    tabs, bases, it2, status2 = _phase_batched(
        tabs, bases, C0, maxiter=maxiter, tol=tol, bland_after=bland_after,
        it0=it1)

    vals = torch.where(bases < C0, tabs[:, :R, -1], 0.0)
    x = torch.zeros((B, C0), dtype=dtype, device=dev).scatter_add_(
        1, bases.long().clamp(0, C0 - 1), vals)
    fun = -tabs[:, -1, -1]
    status = torch.where(status1 != OPTIMAL, status1,
                         torch.where(infeasible, INFEASIBLE, status2))
    return x[:, :nv], fun, status, it2, bases


def _revised_phase(A, c_phase, Binv, xB, bas, *, art_cost: float,
                   maxiter: int, tol: float, bland_after: int, lane_ok,
                   it0=None):
    """Masked batched simplex phase in reduced form: only the (R, R)
    factor and the basic solution are carried per lane (updated in place
    by `ops.reduced_pivot`); every iteration prices all C0 columns out of
    the factor.  Selection rules and status bookkeeping match
    `_phase_batched`; ``art_cost`` prices virtual artificials (1 in phase
    1, 0 in phase 2).  Returns ``(Binv, xB, bas, it, status)``."""
    B = A.shape[0]
    dev = A.device
    lane_ok = (torch.ones(B, dtype=torch.bool, device=dev) if lane_ok is None
               else lane_ok)
    it = (torch.zeros(B, dtype=torch.int32, device=dev) if it0 is None
          else it0.clone())
    status = torch.full((B,), ITERATION_LIMIT, dtype=torch.int32,
                        device=dev)
    degen = torch.zeros(B, dtype=torch.int32, device=dev)
    while _running(status, it, maxiter):
        running = status == ITERATION_LIMIT
        has_enter, unbounded, degen_piv = pivot_ops.reduced_pivot(
            A, c_phase, Binv, xB, bas, degen >= bland_after,
            running & (it < maxiter), lane_ok, art_cost=art_cost, tol=tol)
        status = torch.where(running & ~has_enter, OPTIMAL, status)
        active = running & has_enter & (it < maxiter)
        status = torch.where(active & unbounded, UNBOUNDED, status)
        do_pivot = active & ~unbounded
        degen = torch.where(do_pivot,
                            torch.where(degen_piv, degen + 1, 0), degen)
        it = it + active.to(torch.int32)
    rc = price_reduced_ref(A, c_phase, Binv, bas, art_cost)
    done = ~((rc < -tol) & lane_ok[:, None]).any(dim=1)
    status = torch.where((status == ITERATION_LIMIT) & done, OPTIMAL,
                         status)
    return Binv, xB, bas, it, status


def _revised_two_phase(A, b, c_full, Binv, xB, bas, *, nv, maxiter, tol,
                       bland_after, lane_mask=None):
    """Both simplex phases in reduced form (`_two_phase_virtual`'s twin):
    the infeasibility certificate reads the basic-artificial levels off
    ``xB``.  ``lane_mask`` False lanes never produce an entering column
    (0 pivots, OPTIMAL, x = 0).  Returns ``(x, fun, status, niter,
    bases)``."""
    B, R, C0 = A.shape
    Binv, xB, bas, it1, status1 = _revised_phase(
        A, torch.zeros_like(c_full), Binv, xB, bas, art_cost=1.0,
        maxiter=maxiter, tol=tol, bland_after=bland_after,
        lane_ok=lane_mask)
    art_sum = torch.where(bas >= C0, xB, 0.0).sum(dim=1)
    infeasible = art_sum > max(tol, 1e-5) * (1.0 + b.abs().sum(dim=1))
    if lane_mask is not None:
        infeasible = infeasible & lane_mask

    Binv, xB, bas, it2, status2 = _revised_phase(
        A, c_full, Binv, xB, bas, art_cost=0.0, maxiter=maxiter, tol=tol,
        bland_after=bland_after, lane_ok=lane_mask, it0=it1)

    vals = torch.where(bas < C0, xB, 0.0)
    idx = bas.long().clamp(0, C0 - 1)
    x = torch.zeros((B, C0), dtype=A.dtype, device=A.device).scatter_add_(
        1, idx, vals)
    cb = torch.where(bas < C0, torch.gather(c_full, 1, idx), 0.0)
    fun = (cb * vals).sum(dim=1)
    if lane_mask is not None:
        fun = torch.where(lane_mask, fun, 0.0)
    status = torch.where(status1 != OPTIMAL, status1,
                         torch.where(infeasible, INFEASIBLE, status2))
    return x[:, :nv], fun, status, it2, bas


def _revised_core(A, b, c_full, basis0, *, nv, maxiter, tol,
                  bland_after=BLAND_AFTER, lane_mask=None):
    """Warm-or-cold batched revised simplex (``method="revised"``): a cold
    lane's factor is the identity (xB = b, every row on its virtual
    artificial), a warm lane reuses its repaired `_warm_init_reduced`
    factor, rejected lanes start cold in the same call."""
    B, R, C0 = A.shape
    dev, dtype = A.device, A.dtype
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    bas_c = (C0 + rows).expand(B, R)
    eye = torch.eye(R, dtype=dtype, device=dev).expand(B, R, R)
    if basis0 is None:
        warm_ok = torch.zeros(B, dtype=torch.bool, device=dev)
        Binv, xB, bas = eye.clone(), b.clone(), bas_c.clone()
    else:
        Binv_w, rhs_w, bas_w, warm_ok = _warm_init_reduced(A, b, basis0)
        Binv = torch.where(warm_ok[:, None, None], Binv_w, eye)
        xB = torch.where(warm_ok[:, None], rhs_w, b)
        bas = torch.where(warm_ok[:, None], bas_w, bas_c)
    x, fun, status, niter, bases = _revised_two_phase(
        A, b, c_full, Binv.contiguous(), xB.contiguous(),
        bas.to(torch.int32).contiguous(), nv=nv, maxiter=maxiter, tol=tol,
        bland_after=bland_after, lane_mask=lane_mask)
    return x, fun, status, niter, bases, warm_ok


def simplex_batch_core(A, b, c_full, basis0, *, nv: int, maxiter: int,
                       tol: float = 1e-7, bland_after: int = BLAND_AFTER,
                       lane_mask=None, method: str = "tableau"):
    """Warm-or-cold batched two-phase simplex (the engine's plan solve).

    ``A`` (B, R, C0), ``b`` (B, R) >= 0 and ``c_full`` (B, C0) float64;
    ``basis0`` (B, R) int32 previous bases (rows of -1 start cold) or None
    (every lane cold).  ``lane_mask`` (B,) bool False lanes spend 0 pivots.
    ``method`` is ``"tableau"`` (dense (R+1, C0+1) pivots through the
    simplex_pivot kernel) or ``"revised"`` (the (R, R) basis inverse
    through the reduced_pivot kernel); they agree on statuses and pivot
    counts and to solver tolerance on x/fun.

    Returns ``(x (B, nv), fun, status, niter, basis, warm_ok)``."""
    if A.dtype != torch.float64:
        raise TypeError(f"the LP is float64-only (got {A.dtype}): a float32 "
                        f"simplex cycles until maxiter")
    A, b, c_full = A.contiguous(), b.contiguous(), c_full.contiguous()
    if method == "revised":
        return _revised_core(A, b, c_full, basis0, nv=nv, maxiter=maxiter,
                             tol=tol, bland_after=bland_after,
                             lane_mask=lane_mask)
    if method != "tableau":
        raise ValueError(f"unknown simplex method {method!r}; expected "
                         f"'tableau' or 'revised'")
    B, R, C0 = A.shape
    rows = torch.arange(R, dtype=torch.int32, device=A.device)
    bas_c = (C0 + rows).expand(B, R)
    if basis0 is None:
        warm_ok = torch.zeros(B, dtype=torch.bool, device=A.device)
        tabA, rhs, bas = A, b, bas_c
    else:
        tabA_w, rhs_w, bas_w, warm_ok = _warm_init(A, b, basis0)
        tabA = torch.where(warm_ok[:, None, None], tabA_w, A)
        rhs = torch.where(warm_ok[:, None], rhs_w, b)
        bas = torch.where(warm_ok[:, None], bas_w, bas_c)
    x, fun, status, niter, bases = _two_phase_virtual(
        tabA, rhs, bas.to(torch.int32), b, c_full, nv=nv, maxiter=maxiter,
        tol=tol, bland_after=bland_after, lane_mask=lane_mask)
    return x, fun, status, niter, bases, warm_ok


# --------------------------------------------------------------------------
# implicit differentiation: the VJP at the converged basis
# --------------------------------------------------------------------------
class _SimplexImplicit(torch.autograd.Function):
    """`simplex_batch_core` forward; `kkt_vjp_ref` at the converged bases
    backward.  The pivot loops never enter the graph: only their fixed
    point, the optimal basis, feeds the backward."""

    @staticmethod
    def forward(ctx, A, b, c_full, basis0, lane_mask, cfg):
        out = simplex_batch_core(A, b, c_full, basis0, lane_mask=lane_mask,
                                 **cfg)
        _x, _fun, status, niter, bases, warm_ok = out
        ctx.save_for_backward(A, b, c_full, bases, status, lane_mask)
        ctx.nv = cfg["nv"]
        ctx.mark_non_differentiable(status, niter, bases, warm_ok)
        return out

    @staticmethod
    def backward(ctx, gx, gfun, *_int_cotangents):
        A, b, c_full, bases, status, lane_mask = ctx.saved_tensors
        valid = status == OPTIMAL
        if lane_mask is not None:
            valid = valid & lane_mask
        A_bar, b_bar, c_bar = kkt_vjp_ref(A, b, c_full, bases, gx, gfun,
                                          valid, nv=ctx.nv)
        return A_bar, b_bar, c_bar, None, None, None


def simplex_batch_grad(A, b, c_full, basis0, *, nv: int, maxiter: int,
                       tol: float = 1e-7, bland_after: int = BLAND_AFTER,
                       lane_mask=None, method: str = "tableau"):
    """`simplex_batch_core` with an implicit-function gradient.

    The forward is `simplex_batch_core` itself (the same pivots, on a CUDA
    tensor the ``simplex_pivot`` or ``reduced_pivot`` kernel by
    ``method``; outputs bit for bit).  The backward never differentiates
    the pivot loops: at the converged basis ``B`` the optimum is locally
    ``x_B = B^{-1} b``, so the cotangents of ``(A, b, c_full)`` come from
    one adjoint (R, R) solve per lane (`kernels.simplex_pivot.ref.
    kkt_vjp_ref`).  ``status``, ``niter``, ``bases`` and ``warm_ok`` are
    not differentiable; ``basis0`` and ``lane_mask`` get no gradient.

    Non-OPTIMAL and masked lanes give exact zeros.  At a degenerate
    optimal basis the optimum is not differentiable and the backward
    returns the subgradient of the converged basis."""
    cfg = dict(nv=nv, maxiter=maxiter, tol=tol, bland_after=bland_after,
               method=method)
    return _SimplexImplicit.apply(A, b, c_full, basis0, lane_mask, cfg)


# --------------------------------------------------------------------------
# host entry points: NumPy LPs in, NumPy results out
# --------------------------------------------------------------------------
@dataclasses.dataclass
class LPResult:
    x: np.ndarray
    fun: float
    status: int
    niter: int
    basis: np.ndarray   # row -> basic variable index
    warm: bool = False  # True when a warm_basis start was accepted

    @property
    def success(self) -> bool:
        return self.status == OPTIMAL


@dataclasses.dataclass
class BatchLPResult:
    """`solve_lp_batch` output: a leading batch axis on every field."""
    x: np.ndarray        # (B, nv)
    fun: np.ndarray      # (B,)
    status: np.ndarray   # (B,) int
    niter: np.ndarray    # (B,) int
    basis: np.ndarray    # (B, R) int
    warm: Optional[np.ndarray] = None  # (B,) bool: warm start accepted

    def __len__(self) -> int:
        return self.x.shape[0]

    def __getitem__(self, b: int) -> LPResult:
        return LPResult(x=self.x[b], fun=float(self.fun[b]),
                        status=int(self.status[b]), niter=int(self.niter[b]),
                        basis=self.basis[b],
                        warm=(bool(self.warm[b]) if self.warm is not None
                              else False))


def _canonicalize_batch(c, A_ub, b_ub, A_eq, b_eq):
    """``min c@x s.t. A_ub x <= b_ub, A_eq x == b_eq, x >= 0`` (every
    input with a leading batch axis) as ``A x == b, b >= 0``: one slack
    column per inequality row, rows with a negative rhs flipped.  Returns
    ``(A (B, R, C0), b (B, R), c_full (B, C0), nv, n_slack)``."""
    c = np.asarray(c, dtype=np.float64)
    B, nv = c.shape
    rows, rhs = [], []
    n_ub = 0
    if A_ub is not None:
        A_ub = np.asarray(A_ub, dtype=np.float64)
        b_ub = np.asarray(b_ub, dtype=np.float64)
        n_ub = A_ub.shape[1]
        eye = np.broadcast_to(np.eye(n_ub), (B, n_ub, n_ub))
        rows.append(np.concatenate([A_ub, eye], axis=2))
        rhs.append(b_ub)
    if A_eq is not None:
        A_eq = np.asarray(A_eq, dtype=np.float64)
        b_eq = np.asarray(b_eq, dtype=np.float64)
        pad = np.zeros((B, A_eq.shape[1], n_ub))
        rows.append(np.concatenate([A_eq, pad], axis=2))
        rhs.append(b_eq)
    A = np.concatenate(rows, axis=1)
    b = np.concatenate(rhs, axis=1)
    neg = b < 0
    A = np.where(neg[:, :, None], -A, A)
    b = np.where(neg, -b, b)
    c_full = np.concatenate([c, np.zeros((B, n_ub))], axis=1)
    return A, b, c_full, nv, n_ub


_BACKENDS = ("torch", "numpy")


def _check_backend(backend: str) -> None:
    if backend == "jax":
        raise ValueError("backend='jax' is the reference's batched path; "
                         "the port's is backend='torch'")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{_BACKENDS}")


def solve_lp_batch(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, *,
                   maxiter: Optional[int] = None, tol: float = 1e-7,
                   warm_basis: Optional[np.ndarray] = None,
                   bland_after: int = BLAND_AFTER, method: str = "tableau",
                   backend: str = "torch",
                   device: DeviceLike = None) -> BatchLPResult:
    """Solve B structurally identical LPs in one batched simplex on
    ``device`` (the card unless named), float64.

    ``warm_basis`` (B, R) starts each lane from that basis; lanes whose
    row is -1, out of range, singular or ill-conditioned run the cold
    two-phase solve in the same call (``BatchLPResult.warm`` says which).
    The default ``maxiter`` is the reference's shape-derived budget
    rounded up to a power of two.

    ``backend="numpy"`` solves the lanes one by one with the sequential
    NumPy oracle (`solve_lp(backend="numpy")`: its unrounded default
    budget, ``method`` and ``device`` unused)."""
    _check_backend(backend)
    if backend == "numpy":
        return _solve_lp_batch_np(c, A_ub, b_ub, A_eq, b_eq,
                                  maxiter=maxiter, tol=tol,
                                  warm_basis=warm_basis,
                                  bland_after=bland_after)
    A, b, c_full, nv, _ = _canonicalize_batch(c, A_ub, b_ub, A_eq, b_eq)
    if maxiter is None:
        maxiter = _bucket_maxiter(50 * (A.shape[1] + 2))
    dev = resolve_device(device)
    basis0 = None
    if warm_basis is not None:
        wb = np.asarray(warm_basis, np.int64)
        if wb.shape != A.shape[:2]:
            raise ValueError(f"warm_basis must be (B, R) = {A.shape[:2]}; "
                             f"got {wb.shape}")
        basis0 = torch.as_tensor(wb, device=dev)

    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=dev)

    x, fun, status, niter, basis, ok = simplex_batch_core(
        f64(A), f64(b), f64(c_full), basis0, nv=nv, maxiter=maxiter,
        tol=tol, bland_after=bland_after, method=method)
    return BatchLPResult(x=x.cpu().numpy(), fun=fun.cpu().numpy(),
                         status=status.cpu().numpy().astype(np.int64),
                         niter=niter.cpu().numpy().astype(np.int64),
                         basis=basis.cpu().numpy().astype(np.int64),
                         warm=ok.cpu().numpy())


def _solve_lp_batch_np(c, A_ub, b_ub, A_eq, b_eq, *, maxiter, tol,
                       warm_basis, bland_after) -> BatchLPResult:
    """`solve_lp_batch` lane by lane through the NumPy oracle."""
    c = np.asarray(c, np.float64)
    B = c.shape[0]

    def lane(x, b):
        return None if x is None else np.asarray(x)[b]

    if warm_basis is not None:
        wb = np.asarray(warm_basis, np.int64)
        R = (0 if A_ub is None else np.asarray(A_ub).shape[1]) + \
            (0 if A_eq is None else np.asarray(A_eq).shape[1])
        if wb.shape != (B, R):
            raise ValueError(f"warm_basis must be (B, R) = {(B, R)}; "
                             f"got {wb.shape}")
    res = [solve_lp(c[b], lane(A_ub, b), lane(b_ub, b), lane(A_eq, b),
                    lane(b_eq, b), maxiter=maxiter, tol=tol,
                    warm_basis=lane(warm_basis, b), bland_after=bland_after,
                    backend="numpy") for b in range(B)]
    return BatchLPResult(
        x=np.stack([r.x for r in res]),
        fun=np.array([r.fun for r in res], np.float64),
        status=np.array([r.status for r in res], np.int64),
        niter=np.array([r.niter for r in res], np.int64),
        basis=np.stack([np.asarray(r.basis, np.int64) for r in res]),
        warm=np.array([r.warm for r in res], bool))


def solve_lp(c, A_ub=None, b_ub=None, A_eq=None, b_eq=None, *,
             maxiter: Optional[int] = None, tol: float = 1e-7,
             warm_basis: Optional[np.ndarray] = None,
             bland_after: int = BLAND_AFTER, method: str = "tableau",
             backend: str = "torch",
             device: DeviceLike = None) -> LPResult:
    """Minimize ``c@x`` s.t. ``A_ub x <= b_ub``, ``A_eq x == b_eq``,
    ``x >= 0``.  ``backend="torch"`` (the default) is `solve_lp_batch` at
    B = 1 on ``device``; ``backend="numpy"`` is the reference's sequential
    NumPy oracle in host float64, with the reference's unrounded default
    budget 50 (R + 2).  A ``warm_basis`` rejected by the oracle (stale,
    singular) falls back to its cold two-phase solve (``LPResult.warm``
    says which ran)."""
    _check_backend(backend)
    if backend == "numpy":
        A, b, c_full, nv, n_slack = _canonicalize(c, A_ub, b_ub, A_eq, b_eq)
        if warm_basis is not None \
                and np.asarray(warm_basis).shape != (A.shape[0],):
            raise ValueError(
                f"warm_basis must be ({A.shape[0]},) — one basic column "
                f"per constraint row; got {np.asarray(warm_basis).shape}")
        if maxiter is None:
            maxiter = 50 * (A.shape[0] + 2)
        if warm_basis is not None:
            got = _warm_np(A, b, c_full, nv, warm_basis, maxiter, tol,
                           bland_after)
            if got is not None:
                x, fun, status, niter, basis = got
                return LPResult(x=x, fun=float(fun), status=int(status),
                                niter=int(niter), basis=basis, warm=True)
        x, fun, status, niter, basis = _solve_np(A, b, c_full, nv, n_slack,
                                                 maxiter, tol, bland_after)
        return LPResult(x=x, fun=float(fun), status=int(status),
                        niter=int(niter), basis=basis)

    def one(x):
        return None if x is None else np.asarray(x, np.float64)[None]

    wb = None if warm_basis is None else np.asarray(warm_basis)[None]
    return solve_lp_batch(one(c), one(A_ub), one(b_ub), one(A_eq),
                          one(b_eq), maxiter=maxiter, tol=tol,
                          warm_basis=wb, bland_after=bland_after,
                          method=method, device=device)[0]


# --------------------------------------------------------------------------
# the sequential NumPy oracle (host float64, one instance)
# --------------------------------------------------------------------------
def _canonicalize(c, A_ub, b_ub, A_eq, b_eq):
    """One LP as ``A x == b, b >= 0`` (slack per inequality row, rows with
    a negative rhs flipped): ``(A (R, C0), b (R,), c_full (C0,), nv,
    n_slack)``."""
    c = np.asarray(c, dtype=np.float64)
    nv = c.shape[0]
    rows = []
    rhs = []
    n_ub = 0
    if A_ub is not None:
        A_ub = np.asarray(A_ub, dtype=np.float64)
        b_ub = np.asarray(b_ub, dtype=np.float64)
        n_ub = A_ub.shape[0]
        rows.append(np.concatenate([A_ub, np.eye(n_ub)], axis=1))
        rhs.append(b_ub)
    if A_eq is not None:
        A_eq = np.asarray(A_eq, dtype=np.float64)
        b_eq = np.asarray(b_eq, dtype=np.float64)
        pad = np.zeros((A_eq.shape[0], n_ub))
        rows.append(np.concatenate([A_eq, pad], axis=1))
        rhs.append(b_eq)
    A = np.concatenate(rows, axis=0)
    b = np.concatenate(rhs, axis=0)
    neg = b < 0
    A[neg] *= -1.0
    b[neg] *= -1.0
    c_full = np.concatenate([c, np.zeros(n_ub)])
    return A, b, c_full, nv, n_ub


def _warm_np(A, b, c_full, nv, basis0, maxiter, tol, bland_after):
    """Warm start of one instance: factor the basis, repair infeasible
    rows with (materialized) artificials, then warm phase 1 and phase 2.
    Returns an LPResult tuple, or None when the basis is rejected (out of
    range, singular or ill-conditioned)."""
    R, C0 = A.shape
    C = C0 + R
    basis0 = np.asarray(basis0)
    if basis0.shape != (R,) or (basis0 < 0).any() or (basis0 >= C0).any():
        return None
    Bmat = A[:, basis0]
    try:
        Binv = np.linalg.solve(Bmat, np.eye(R))
    except np.linalg.LinAlgError:
        return None
    resid = np.max(np.abs(Bmat @ Binv - np.eye(R)))
    if not np.isfinite(resid) or resid >= 1e-6:
        return None
    rhs = Binv @ b
    tabA = Binv @ A

    flip = rhs < -1e-9                       # feasibility-repair rows
    sgn = np.where(flip, -1.0, 1.0)
    tabA = tabA * sgn[:, None]
    rhs = np.maximum(rhs * sgn, 0.0)
    basis = basis0.astype(np.int64).copy()
    basis[flip] = C0 + np.nonzero(flip)[0]

    tab = np.zeros((R + 1, C + 1))
    tab[:R, :C0] = tabA
    tab[:R, C0:C] = np.eye(R)
    tab[:R, -1] = rhs
    tab[-1, :] = -tab[:R, :][flip].sum(axis=0)
    tab[-1, C0:C] = 0.0
    tab, basis, it1, st1 = _phase_np(tab, basis, C0, maxiter, tol,
                                     bland_after)
    infeasible = tab[-1, -1] < -max(tol, 1e-8) * (1.0 + np.abs(b).sum())

    obj = np.zeros(C + 1)
    obj[:C0] = c_full
    obj = obj - obj[basis] @ tab[:R, :]
    tab[-1, :] = obj
    tab, basis, it2, st2 = _phase_np(tab, basis, C0, maxiter, tol,
                                     bland_after, it0=it1)
    x = np.zeros(C)
    x[basis] = tab[:R, -1]
    if st1 != OPTIMAL:
        status = st1
    else:
        status = INFEASIBLE if infeasible else st2
    return x[:nv], -tab[-1, -1], status, it2, basis


def _phase_np(tab, basis, art_start, maxiter, tol,
              bland_after=BLAND_AFTER, it0=0):
    """One simplex phase on a dense tableau with the objective in its last
    row.  ``it0`` seeds the iteration counter (cumulative across phases,
    so ``maxiter`` caps the two-phase total); optimality is checked
    before the cap."""
    R = tab.shape[0] - 1
    C = tab.shape[1] - 1
    it = it0
    degen = 0
    while True:
        rc = tab[-1, :C]
        enter = np.where((rc < -tol) & (np.arange(C) < art_start))[0]
        if enter.size == 0:
            return tab, basis, it, OPTIMAL
        if it >= maxiter:
            return tab, basis, it, ITERATION_LIMIT
        if degen >= bland_after:
            j = enter[0]                  # Bland: smallest eligible index
        else:
            j = enter[np.argmin(rc[enter])]
        col = tab[:R, j]
        rhs = tab[:R, -1]
        ratio = np.full(R, np.inf)
        pos = col > tol
        ratio[pos] = rhs[pos] / col[pos]
        art_basic = (basis >= art_start) & (np.abs(col) > tol) & (rhs <= tol)
        ratio[art_basic] = 0.0
        if not np.any(ratio < np.inf):
            return tab, basis, it, UNBOUNDED
        rmin = ratio.min()
        tie = ratio <= rmin + max(abs(rmin) * 1e-9, 1e-12)
        cand = np.where(tie)[0]
        r = cand[np.argmin(basis[cand])]
        piv = tab[r, j]
        tab[r] = tab[r] / piv
        for k in range(tab.shape[0]):
            if k != r and abs(tab[k, j]) > 0:
                tab[k] -= tab[k, j] * tab[r]
        basis[r] = j
        degen = degen + 1 if rmin <= tol else 0
        it += 1


def _solve_np(A, b, c_full, nv, n_slack, maxiter, tol,
              bland_after=BLAND_AFTER):
    """Cold two-phase solve of one instance, every row starting on its
    own artificial."""
    R, C0 = A.shape
    C = C0 + R
    tab = np.zeros((R + 1, C + 1))
    tab[:R, :C0] = A
    tab[:R, C0:C] = np.eye(R)
    tab[:R, -1] = b
    tab[-1, :] = -tab[:R, :].sum(axis=0)
    tab[-1, C0:C] = 0.0
    basis = np.arange(C0, C, dtype=np.int64)

    tab, basis, it1, st1 = _phase_np(tab, basis, C0, maxiter, tol,
                                     bland_after)
    infeasible = tab[-1, -1] < -max(tol, 1e-8) * (1.0 + np.abs(b).sum())

    obj = np.zeros(C + 1)
    obj[:C0] = c_full
    obj = obj - obj[basis] @ tab[:R, :]
    tab[-1, :] = obj
    tab, basis, it2, st2 = _phase_np(tab, basis, C0, maxiter, tol,
                                     bland_after, it0=it1)

    x = np.zeros(C)
    x[basis] = tab[:R, -1]
    fun = -tab[-1, -1]
    # an unconverged phase 1 voids both the infeasibility certificate and
    # the phase-2 result
    if st1 != OPTIMAL:
        status = st1
    else:
        status = INFEASIBLE if infeasible else st2
    return x[:nv], fun, status, it2, basis
