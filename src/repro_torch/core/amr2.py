"""AMR^2 — Accuracy Maximization using LP-Relaxation and Rounding (paper
§IV), batched over a fleet of devices.

Port of the engine path of `repro.core.amr2`: the LP build
(`build_lp_arrays`, counterpart of `build_lp_arrays_jnp`) and the
Algorithm 1/2 rounding case tree (`round_relaxation`, counterpart of
`round_relaxation_jnp`).  A basic optimal solution of the relaxation has
at most two fractional jobs (Lemma 1); the rounding keeps the integral
part, best-fits one fractional job and solves the two-job sub-ILP by
(m+1)^2 enumeration, so the makespan stays within 2T (Theorem 1).
"""
from __future__ import annotations

import torch

from .lp import INFEASIBLE, OPTIMAL

_FRAC_TOL = 1e-4

# status codes of the rounding, shared with `core.problem`
ST_OK, ST_FALLBACK, ST_INFEASIBLE = 0, 1, 2
ST_UNSOLVED = 4


def build_lp_arrays(p_ed, p_es, acc, T):
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


def round_relaxation(p_ed, p_es, acc, T, xbar, status, *,
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
