"""Plain reference of one fleet period under AMR² (arXiv:2112.11413,
Algorithm 1 with its LP relaxation), written from the algorithm, not
from the port: plain PyTorch and NumPy, no import of the port.

One period, for every device of the fleet:

1. release the replayed arrivals: backlog plus this period's count, at
   most ``batch_max`` jobs, their classes read in arrival order;
2. solve the LP relaxation of each device (maximise summed accuracy; the
   ED and the ES each within T; each job's weights sum to 1) with a
   dense two-phase tableau simplex under Bland's rule;
3. round it (Algorithm 1: the integral jobs keep their model; one
   fractional job takes the most accurate model that fits alone; two are
   settled by enumerating their pair of models, each pair within T);
   an infeasible LP runs every job on its fastest local model;
4. admit the offloading devices to the ES pool: ascending ES demand,
   each on the least-loaded server, until the first that does not fit;
5. replan the devices that were not admitted with the ES disabled;
6. price the plan, and run the EMA straggler audit on the ED's wall
   (under faults also the ES audit); where an audit's ratio ties the
   threshold, the compared side's verdict stands, since which side of
   the tie a sum lands on depends only on its order of rounding.

``dtype`` float64 is the reference; float32 is the control of the
benchmark's comparison (the same arithmetic one precision lower).
"""
from __future__ import annotations

import heapq
from typing import Dict

import numpy as np
import torch

ES_DISABLED = 1e9      # ES latency of a job whose device has no ES link
FRAC_TOL = 1e-4        # an LP weight within this of 0 or 1 is integral
PIVOT_TOL = 1e-9       # a column enters below -PIVOT_TOL; a pivot above
MAX_ITER = 400         # per phase; a lane past it is unsolved
# an audit ratio within this many units in the last place of the
# threshold is a tie that the order of rounding decides: a straggler of
# drift 3 whose belief one audit at EMA 0.5 doubled reads 3 / 2 = 1.5
TIE_ULPS = 64


def lp_arrays(p_ed, p_es, acc, T):
    """The relaxation in equality form: rows ED budget, ES budget, then
    one per job; columns the (job, model) weights in job-major order, then
    the two budget slacks.  ``p_ed`` (B, n, m), ``p_es`` (B, n), ``acc``
    (B, m + 1).  Returns ``(A (B, n + 2, n (m + 1) + 2), b (B, n + 2),
    cost (B, n (m + 1) + 2))``, cost to be minimised."""
    B, n, m = p_ed.shape
    k = m + 1
    dt, dev = p_ed.dtype, p_ed.device
    A = torch.zeros((B, n + 2, n * k + 2), dtype=dt, device=dev)
    var = A[:, :, :n * k].view(B, n + 2, n, k)
    var[:, 0, :, :m] = p_ed
    var[:, 1, :, m] = p_es
    jobs = torch.arange(n, device=dev)
    var[:, 2 + jobs, jobs, :] = 1.0
    A[:, 0, n * k] = 1.0
    A[:, 1, n * k + 1] = 1.0
    b = torch.ones((B, n + 2), dtype=dt, device=dev)
    b[:, :2] = T
    cost = torch.zeros((B, n * k + 2), dtype=dt, device=dev)
    cost[:, :n * k] = -acc.repeat(1, n)
    return A, b, cost


def _pivots(tab, basis, allowed, tol):
    """Bland's rule on every lane until none has an entering column or
    ``MAX_ITER`` pivots: first column of negative reduced cost among
    ``allowed``; leaving row by the least ratio, ties to the least basis
    label.  ``tab`` (B, R + 1, C + 1): R rows, the objective row last,
    the right-hand side last.  Returns the lanes that stopped optimal."""
    B, R1, C1 = tab.shape
    R = R1 - 1
    lanes = torch.arange(B, device=tab.device)
    done = torch.zeros(B, dtype=torch.bool, device=tab.device)
    for _ in range(MAX_ITER):
        rc = tab[:, R, :C1 - 1]
        cand = (rc < -tol) & allowed[None, :]
        has = cand.any(dim=1) & ~done
        done = done | ~cand.any(dim=1)
        if not bool(has.any()):
            return done
        enter = cand.to(torch.uint8).argmax(dim=1)
        col = tab[lanes, :, enter]                          # (B, R + 1)
        rhs = tab[:, :R, C1 - 1]
        pos = col[:, :R] > tol
        ratio = torch.where(pos, rhs / torch.where(pos, col[:, :R], 1.0),
                            torch.inf)
        best = ratio.min(dim=1, keepdim=True).values
        label = torch.where(ratio == best, basis, torch.iinfo(
            basis.dtype).max)
        leave = label.argmin(dim=1)
        bounded = torch.isfinite(best[:, 0])
        go = has & bounded
        prow = tab[lanes, leave] / torch.where(
            go, col[lanes, leave], 1.0)[:, None]           # (B, C + 1)
        new = tab - col[:, :, None] * prow[:, None, :]
        new[lanes, leave] = prow
        tab.copy_(torch.where(go[:, None, None], new, tab))
        basis[lanes, leave] = torch.where(go, enter, basis[lanes, leave])
        done = done | (has & ~bounded)
    return done


def solve_lp(A, b, cost, *, tol: float = PIVOT_TOL):
    """Two-phase simplex on every lane (``b`` >= 0): phase 1 from the
    slacks of the two budget rows and an artificial on every job row;
    phase 2 with the artificials barred.  Returns ``(x (B, C), status
    (B,))``: 0 optimal, 2 infeasible, 1 unsolved (a phase hit
    ``MAX_ITER``)."""
    B, R, C = A.shape
    dt, dev = A.dtype, A.device
    n_art = R - 2
    tab = torch.zeros((B, R + 1, C + n_art + 1), dtype=dt, device=dev)
    tab[:, :R, :C] = A
    art = torch.arange(n_art, device=dev)
    tab[:, 2 + art, C + art] = 1.0
    tab[:, :R, -1] = b
    basis = torch.empty((B, R), dtype=torch.int64, device=dev)
    basis[:, 0], basis[:, 1] = C - 2, C - 1
    basis[:, 2:] = C + art
    # phase 1: minimise the artificials' sum; its reduced costs are minus
    # the column sums of the job rows
    tab[:, R, :] = -tab[:, 2:R, :].sum(dim=1)
    tab[:, R, C:C + n_art] = 0.0
    every = torch.ones(C + n_art, dtype=torch.bool, device=dev)
    ok1 = _pivots(tab, basis, every, tol)
    art_level = torch.where(basis >= C, tab[:, :R, -1], 0.0).sum(dim=1)
    infeasible = art_level > 1e-5 * (1.0 + b.abs().sum(dim=1))
    # phase 2: the cost row priced against the phase-1 basis
    cB = torch.where(basis < C, torch.gather(
        cost, 1, basis.clamp(max=C - 1)), 0.0)
    full = torch.cat([cost, torch.zeros((B, n_art), dtype=dt, device=dev)],
                     dim=1)
    tab[:, R, :-1] = full - torch.einsum("br,brc->bc", cB, tab[:, :R, :-1])
    tab[:, R, -1] = -(cB * tab[:, :R, -1]).sum(dim=1)
    structural = torch.arange(C + n_art, device=dev) < C
    ok2 = _pivots(tab, basis, structural, tol)
    x = torch.zeros((B, C + n_art), dtype=dt, device=dev)
    x.scatter_(1, basis, tab[:, :R, -1])
    status = torch.where(infeasible, 2, torch.where(ok1 & ok2, 0, 1))
    return x[:, :C], status


def round_plan(p_ed, p_es, acc, T, xbar, status):
    """Algorithm 1's rounding of ``xbar`` (B, n, m + 1): returns the
    assignment (B, n), model index per job (m is the ES)."""
    B, n, k = xbar.shape
    m = k - 1
    dev = xbar.device
    lanes = torch.arange(B, device=dev)
    ok = status == 0
    infeasible = status == 2
    assign = xbar.argmax(dim=2)
    assign = torch.where(infeasible[:, None], p_ed.argmin(dim=2), assign)
    frac = ((xbar > FRAC_TOL) & (xbar < 1.0 - FRAC_TOL)).any(dim=2) \
        & ok[:, None]
    fc = frac.sum(dim=1)
    # the pair: the first two fractional jobs, or with more than two the
    # two most fractional (a stable sort), in job order
    first = frac.to(torch.uint8).argmax(dim=1)
    rest = frac.clone()
    rest[lanes, first] = False
    second = rest.to(torch.uint8).argmax(dim=1)
    score = torch.where(frac, 1.0 - xbar.amax(dim=2), -torch.inf)
    top = torch.argsort(-score, dim=1, stable=True)[:, :2]
    many = ok & (fc > 2)
    j1 = torch.where(many, top.amin(dim=1), first)
    j2 = torch.where(many, top.amax(dim=1), second)
    Tb = T.expand(B)
    ed1, ed2 = p_ed[lanes, j1], p_ed[lanes, j2]               # (B, m)
    es1, es2 = p_es[lanes, j1], p_es[lanes, j2]               # (B,)
    # one fractional job: the most accurate model it fits alone
    fits = torch.cat([ed1 <= Tb[:, None], (es1 <= Tb)[:, None]], dim=1)
    pick = torch.where(fits, acc, -torch.inf).argmax(dim=1)
    pick = torch.where(fits.any(dim=1), pick, ed1.argmin(dim=1))
    one = ok & (fc == 1)
    cols = torch.arange(n, device=dev)[None, :]
    assign = torch.where(one[:, None] & (cols == j1[:, None]),
                         pick[:, None], assign)
    # two: the best pair of models, each tier's load within T
    zero = torch.zeros((B, 1), dtype=xbar.dtype, device=dev)
    t1 = torch.cat([ed1, zero], dim=1)
    t2 = torch.cat([ed2, zero], dim=1)
    s1 = torch.cat([torch.zeros_like(ed1), es1[:, None]], dim=1)
    s2 = torch.cat([torch.zeros_like(ed2), es2[:, None]], dim=1)
    lim = Tb[:, None, None] + 1e-12
    pair_ok = ((t1[:, :, None] + t2[:, None, :] <= lim)
               & (s1[:, :, None] + s2[:, None, :] <= lim))
    val = torch.where(pair_ok, acc[:, :, None] + acc[:, None, :], -torch.inf)
    flat = val.reshape(B, -1).argmax(dim=1)
    none = ~pair_ok.reshape(B, -1).any(dim=1)
    i1 = torch.where(none, ed1.argmin(dim=1), flat // k)
    i2 = torch.where(none, ed2.argmin(dim=1), flat % k)
    two = ok & (fc >= 2)
    assign = torch.where(two[:, None] & (cols == j1[:, None]), i1[:, None],
                         assign)
    assign = torch.where(two[:, None] & (cols == j2[:, None]), i2[:, None],
                         assign)
    return assign


def plan(p_ed, p_es, acc, T):
    """LP relaxation and rounding of every lane: ``(assign, status)``."""
    B, n, m = p_ed.shape
    A, b, cost = lp_arrays(p_ed, p_es, acc, T)
    x, status = solve_lp(A, b, cost)
    xbar = x[:, :n * (m + 1)].reshape(B, n, m + 1)
    return round_plan(p_ed, p_es, acc, T, xbar, status), status


def admit(demand: np.ndarray, T: float, n_servers: int):
    """The ES pool's admission, sequentially on the host: devices with
    demand > 0 in ascending demand (device order on ties), each onto the
    least-loaded server (lowest index on ties), admitted while it fits
    within T; the first that does not fit and every later one are
    refused.  Returns ``(admitted (D,) bool, total admitted load)``."""
    order = np.argsort(np.where(demand > 0, demand, np.inf), kind="stable")
    heap = [(0.0, s) for s in range(n_servers)]
    admitted = np.zeros(demand.shape[0], dtype=bool)
    loads = np.zeros(n_servers)
    for d in order:
        if demand[d] <= 0:
            break
        load, s = heap[0]
        new = load + demand[d]
        if new > T + 1e-12:
            break
        heapq.heapreplace(heap, (new, s))
        loads[s] = new
        admitted[d] = True
    return admitted, float(loads.sum())


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    """(D, n) summed over the slots in slot order."""
    out = x[:, 0]
    for j in range(1, x.shape[1]):
        out = out + x[:, j]
    return out


def local_fill(lat, acc_local, budget, eligible):
    """Each eligible job in job order takes the most accurate local model
    (lowest index on ties) that fits what is left of ``budget``: returns
    ``(choice (D, n), fit (D, n), time spent (D,))``."""
    D, n, m = lat.shape
    lanes = torch.arange(D, device=lat.device)
    left = budget.clone()
    choice = torch.full((D, n), m, dtype=torch.int64, device=lat.device)
    fit = torch.zeros((D, n), dtype=torch.bool, device=lat.device)
    for j in range(n):
        fits = lat[:, j] <= left[:, None] + 1e-12
        pick = torch.where(fits, acc_local, -torch.inf).argmax(dim=1)
        take = eligible[:, j] & fits.any(dim=1)
        left = left - torch.where(take, lat[lanes, j, pick], 0.0)
        choice[:, j] = torch.where(take, pick, m)
        fit[:, j] = take
    return choice, fit, budget - left


def ladder(faults, real, *, mask, es_on, acc_jobs, p_es_true, ed_wall,
           lat_local, acc, T, retries: int):
    """The period's plan run through its fault draw: each admitted offload
    is lost per attempt as drawn (all of them if the pool crashed); up to
    ``retries`` rounds resend the lost ones (each round a capped doubling
    backoff plus the resend at the degraded link) while the device's ES
    time is under 2T and the pool is up; what is still lost runs on the
    most accurate local model that fits the room left under 2T, else is
    dropped (accuracy 0).  Returns the realized numbers per device."""
    D, n, m = lat_local.shape
    deadline = 2.0 * T
    link = real["link_factor"]
    cost = torch.where(es_on, p_es_true, 0.0)
    es_time = _slot_sum(cost) * link
    failed = es_on & (real["lost"][:, :, 0] | real["es_crash"])
    n_retries = torch.zeros(D, dtype=torch.int64, device=acc.device)
    for k in range(1, retries + 1):
        backoff = min(faults["backoff_base"] * 2.0 ** (k - 1),
                      faults["backoff_cap"])
        can = ~real["es_crash"] & (es_time < deadline) & failed.any(dim=1)
        again = failed & can[:, None]
        resend = _slot_sum(torch.where(again, cost, 0.0)) * link
        es_time = es_time + torch.where(can, backoff + resend, 0.0)
        n_retries = n_retries + again.sum(dim=1)
        failed = torch.where(again, real["lost"][:, :, k], failed)
    ed_real = ed_wall * real["straggler_factor"]
    room = torch.clamp_min(deadline - ed_real, 0.0)
    choice, fit, spent = local_fill(lat_local, acc[:, :m], room, failed)
    dropped = failed & ~fit
    ed_final = ed_real + spent
    ok = es_on & ~failed
    local_acc = torch.gather(acc, 1, choice.clamp(0, m - 1))
    acc_real = torch.where(dropped, 0.0, torch.where(fit, local_acc,
                                                     acc_jobs))
    miss = (dropped | ((mask & ~es_on | fit) & (ed_final > deadline)[:, None])
            | (ok & (es_time > deadline)[:, None]))
    return {"acc": acc_real, "ed_final": ed_final, "ed_audit": ed_real,
            "es_time": es_time, "n_offload_samples": es_on.sum(),
            "n_offload_ok": ok.sum(), "n_retries": n_retries.sum(),
            "n_fallback_local": fit.sum(), "n_dropped": dropped.sum(),
            "n_deadline_miss": miss.sum(), "dropped": dropped.sum(dim=1)}


def audited(ratio, thr, eligible, forced, verdict):
    """The devices an audit updates: ``eligible`` ones whose ``ratio``
    passes ``thr``, or that are ``forced``; where the ratio ties the
    threshold (``TIE_ULPS``), the ``verdict`` given for the device
    stands, if one is given.  Returns ``(updated, tied)``."""
    own = eligible & ((ratio > thr) | forced)
    if verdict is None:
        return own, torch.zeros_like(own)
    tol = TIE_ULPS * torch.finfo(ratio.dtype).eps * thr
    tied = eligible & ~forced & ((ratio - thr).abs() <= tol)
    return torch.where(tied, verdict, own), tied


def period(arr: Dict[str, torch.Tensor], state, t: int, cfg, traffic,
           dtype=torch.float64, verdicts=None) -> Dict[str, torch.Tensor]:
    """Period ``t`` of the whole fleet from ``state`` (its ``p_ed`` (D, c,
    m) ED beliefs, ``p_es_belief`` (D, c) priced ES table, ``pending``
    and ``head`` (D,)), in ``dtype``.  ``arr`` holds the fleet's arrays as
    tensors on one device, and under faults (``traffic["faults"]``) the
    period's draw as ``fault_*`` arrays with a leading period axis.
    ``verdicts``, if given, holds the compared side's updates of the two
    audits (``"ed"``, ``"es"``: (D,) bool), which stand where the audit
    ratio ties the threshold.  Returns the next state's ``pending``,
    ``head``, ``p_ed`` and ``p_es_belief``, the period's fleet numbers,
    each audit's updates (``ed_updated``, ``es_updated``), and how many
    devices tied (``n_tied``) and of those how many the verdict settled
    against the reference's own rounding (``n_tied_flipped``)."""
    verdicts = verdicts or {}
    belief, pending, head = state.p_ed, state.pending, state.head
    dev = belief.device
    n = int(cfg["batch_max"])
    thr, ema = float(cfg["straggler_threshold"]), float(cfg["ema"])
    H = arr["drift"].shape[1]
    f = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in arr.items()}
    belief = belief.to(dtype)
    es_belief = state.p_es_belief.to(dtype)
    T = f["T"].reshape(())
    D, c, m = belief.shape
    # arrivals
    avail = pending + f["counts"][t % f["counts"].shape[0]]
    take = avail.clamp(max=n)
    S = f["stream"].shape[1]
    slot = torch.arange(n, device=dev)
    ci = torch.gather(f["stream"], 1, (head[:, None] + slot[None, :]).clamp(
        0, S - 1).long()).long()
    mask = slot[None, :] < take[:, None]
    rows = torch.arange(D, device=dev)[:, None]
    p_ed = torch.where(mask[..., None], belief[rows, ci], 0.0)
    base = torch.where(mask[..., None], f["base_p_ed"][rows, ci], 0.0)
    out_t = f["outage"][:, t % H]

    def es_jobs(table):
        e = torch.where(mask, table[rows, ci], 0.0)
        return torch.where(out_t[:, None] & mask, ES_DISABLED, e)
    p_es = es_jobs(es_belief)
    acc = f["acc"]
    assign, status = plan(p_ed, p_es, acc, T)
    # ES demand per device, summed slot by slot
    demand = _slot_sum(torch.where(mask & (assign == m), p_es, 0.0))
    admitted, load = admit(demand.double().cpu().numpy(), float(T),
                           int(cfg["n_servers"]))
    admitted = torch.as_tensor(admitted, device=dev)
    offl = demand > 0
    bumped = offl & ~admitted
    unsolved = (status == 1).sum()
    if bool(bumped.any()):
        idx = bumped.nonzero()[:, 0]
        no_es = torch.where(mask[idx], ES_DISABLED, 0.0).to(dtype)
        a2, s2 = plan(p_ed[idx], no_es, acc[idx], T)
        assign = assign.clone()
        assign[idx] = a2
        unsolved = unsolved + (s2 == 1).sum()
    # pricing
    acc_jobs = torch.gather(acc, 1, assign)
    on_ed = mask & (assign < m)
    picked = assign.clamp(0, m - 1)[..., None]
    ed_pred = torch.where(on_ed, torch.gather(p_ed, 2, picked)[..., 0],
                          0.0).sum(dim=1)
    drift_t = f["drift"][:, t % H]
    ed_wall = torch.where(on_ed, torch.gather(base, 2, picked)[..., 0],
                          0.0).sum(dim=1) * drift_t
    es_wall = torch.where(admitted, demand, 0.0)
    es_on = mask & (assign == m)
    out = {}
    if traffic.get("faults"):
        h = t % f["fault_link_factor"].shape[0]
        real = {k: f["fault_" + k][h] for k in
                ("es_crash", "link_factor", "straggler_factor", "lost")}
        rx = ladder(traffic["faults"], real, mask=mask, es_on=es_on,
                    acc_jobs=acc_jobs, p_es_true=es_jobs(f["p_es"]),
                    ed_wall=ed_wall,
                    lat_local=base * (drift_t * real["straggler_factor"]
                                      )[:, None, None],
                    acc=acc, T=T, retries=int(traffic["max_retries"]))
        total_acc = torch.where(mask, rx["acc"], 0.0).sum()
        wall = torch.maximum(rx["ed_final"], rx["es_time"])
        ed_audit = rx["ed_audit"]
        # the ES audit: a device whose realized ES time blew past its
        # priced demand, or that dropped offloads, inflates its ES belief
        es_ratio = rx["es_time"] / torch.clamp_min(es_wall, 1e-9)
        es_upd, es_tied = audited(es_ratio, thr, es_wall > 0,
                                  rx["dropped"] > 0, verdicts.get("es"))
        es_flip = es_tied & (es_upd != (es_ratio > thr))
        es_factor = (1.0 - ema) + ema * torch.clamp_min(es_ratio, thr)
        es_belief = torch.where(es_upd[:, None],
                                es_belief * es_factor[:, None], es_belief)
        out.update({k: rx[k] for k in (
            "n_offload_samples", "n_offload_ok", "n_retries",
            "n_fallback_local", "n_dropped", "n_deadline_miss")},
            n_es_audit_updates=es_upd.sum())
    else:
        total_acc = torch.where(mask, acc_jobs, 0.0).sum()
        wall = torch.maximum(ed_wall, es_wall)
        ed_audit = ed_wall
        es_upd = es_tied = es_flip = torch.zeros(D, dtype=torch.bool,
                                                 device=dev)
    viol = torch.clamp_min(wall / T - 1.0, 0.0)
    # the EMA straggler audit
    ratio = ed_audit / torch.clamp_min(ed_pred, 1e-9)
    upd, tied = audited(ratio, thr, ed_pred > 0, torch.zeros_like(mask[:, 0]),
                        verdicts.get("ed"))
    flip = tied & (upd != (ratio > thr))
    factor = (1.0 - ema) + ema * ratio
    new_belief = torch.where(upd[:, None, None],
                             belief * factor[:, None, None], belief)
    out.update({
        "pending": (avail - take).to(torch.int32),
        "head": (head + take).to(torch.int32),
        "p_ed": new_belief,
        "p_es_belief": es_belief,
        "n_jobs": mask.sum(),
        "total_accuracy": total_acc,
        "n_violations": (viol > 0).sum(),
        "worst_violation": viol.amax(),
        "realized_makespan": wall.amax(),
        "n_offloading": offl.sum(),
        "n_backpressured": bumped.sum(),
        "n_outage": out_t.sum(),
        "n_straggler_updates": upd.sum(),
        "n_unsolved": unsolved,
        "es_utilization": torch.tensor(
            load / (int(cfg["n_servers"]) * float(T)), dtype=dtype,
            device=dev),
        "backlog": (avail - take).sum(),
        "ed_updated": upd,
        "es_updated": es_upd,
        "n_tied": int(tied.sum() + es_tied.sum()),
        "n_tied_flipped": int(flip.sum() + es_flip.sum()),
    })
    return out
