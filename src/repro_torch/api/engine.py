"""Fleet engine: `EngineParams`, `EngineState`, `step` and `rollout`.

Port of the base path of `repro.api.engine` — ``policy="amr2"`` or
``"dual"`` with no scenario armed, replayed or Poisson arrivals.  Each
period:

  * releases this period's arrivals (`_arrivals`): from the replayed
    trace, or drawn on the params' device (``arrivals="poisson"``);
  * assembles the padded `FleetProblem` (outage periods price the ES at
    the disabled sentinel; a lane whose outage flag flipped starts cold);
  * plans every device in one batched solve (`_plan`): under amr2
    `amr2.build_lp_arrays_torch` -> `lp.simplex_batch_core` (warm from last
    period's basis) -> `amr2.round_relaxation_torch`; under dual the
    bisection `dual.dual_one_batch`, which carries no basis;
  * recovers lanes whose LP did not finish with the greedy local fill
    (`_recover_unsolved`);
  * admits offloads to the ES pool (`mobility.admit_mask_pool`);
  * replans the devices admission bumped, ES disabled, in a lane-masked
    cold solve;
  * prices the plan, runs the EMA straggler audit and emits
    `PeriodMetrics`.

The reference scans a jitted step with ``lax.scan``; here `rollout` is a
Python loop over `step`, and the simplex phases inside read their loop
condition on the host.  Everything is float64 (`_require_f64`): a float32
simplex cycles until ``maxiter``.

Poisson arrivals cannot redraw jax's threefry streams: each period's
counts (`torch.poisson`) and job classes (`torch.multinomial`) come from
generators on the params' device seeded from (seed, period), drawn for
the whole fleet at once, so a device's draw depends only on the seed, the
period and its index in the fleet.  They match the reference in
distribution, not draw for draw.

Entry points run on the CUDA card unless given ``device="cpu"``; with no
card and no device they raise.  Not ported yet (each raises
`NotImplementedError` naming its ROADMAP item): the chaos / mobility / HI
/ differentiable scenarios and the sharded entry points.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, check_device, resolve_device
from ..core.amr2 import build_lp_arrays_torch, round_relaxation_torch
from ..core.dual import dual_one_batch
from ..core.faults import greedy_local_fill
from ..core.lp import _bucket_maxiter, simplex_batch_core
from ..core.mobility import admit_mask_pool
from ..core.problem import ES_DISABLED_SENTINEL, ST_UNSOLVED, FleetProblem

TRACEABLE_POLICIES = ("amr2", "dual")

_ROADMAP = {
    "chaos": "the chaos scenario is not ported yet (ROADMAP §1 item 9)",
    "mobility": "the mobility scenario is not ported yet (ROADMAP §1 "
                "item 9)",
    "hi": "online hierarchical inference is not ported yet (ROADMAP §1 "
          "item 9)",
    "differentiable": "the differentiable rollout is not ported yet "
                      "(ROADMAP §1 item 9)",
    "sharded": "the sharded engine is not ported yet (ROADMAP §1 item 10)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(_ROADMAP[what])


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Rollout-invariant fleet description: tensors on one device plus the
    solver configuration.

    Per-class tables are indexed by the QUEUE class table (re-indexed from
    each device's profile at construction).  ``drift``/``outage`` are
    per-period schedules cycled past their horizon; ``counts`` (H, D) and
    ``stream`` (D, S) hold the presampled arrival trace
    (`RequestQueue.presample`) the replay mode releases from; ``rate``
    and ``class_probs`` are what the Poisson mode draws from.  The
    reference's ``classes`` leaf (class labels, for reference only) is
    not carried."""

    base_p_ed: torch.Tensor    # (D, c, m) ground-truth ED latencies
    p_es: torch.Tensor         # (D, c) ES latencies (comm incl.)
    acc: torch.Tensor          # (D, m+1) accuracies
    T: torch.Tensor            # () period budget
    rate: torch.Tensor         # (D,) Poisson arrival rates
    class_probs: torch.Tensor  # (c,) class sampling distribution
    drift: torch.Tensor        # (D, H) true per-period ED slowdown
    outage: torch.Tensor       # (D, H) bool, ES link down
    counts: torch.Tensor       # (Hc, D) int32 replayed arrival counts
    stream: torch.Tensor       # (D, S) int32 replayed class indices
    policy: str = "amr2"
    arrivals: str = "replay"
    n_servers: int = 1
    batch_max: int = 12
    straggler_threshold: float = 1.5
    ema: float = 0.5
    frac_tol: float = 1e-4
    iters: int = 40            # dual bisection steps
    maxiter: Optional[int] = None
    tol: float = 1e-7
    lp_method: str = "tableau"

    @property
    def device(self) -> torch.device:
        return self.base_p_ed.device

    @property
    def n_devices(self) -> int:
        return self.base_p_ed.shape[0]

    @property
    def n_basis_rows(self) -> int:
        """Simplex rows R = batch_max + 2 (warm-basis width)."""
        return self.batch_max + 2

    @classmethod
    def from_fleet(cls, devices, queue, *, T: float, n_servers: int = 1,
                   policy: str = "amr2", horizon: int = 64,
                   arrivals: str = "replay",
                   straggler_threshold: float = 1.5, ema: float = 0.5,
                   frac_tol: float = 1e-4, iters: int = 40,
                   maxiter: Optional[int] = None, tol: float = 1e-7,
                   lp_method: str = "tableau", faults=None, mobility=None,
                   device: DeviceLike = None) -> "EngineParams":
        """Build params from `DeviceSpec`s and a `RequestQueue` (one shape
        group: every profile shares a class table and model count).
        ``device`` defaults to the CUDA card.  Only the replay mode
        presamples the queue's trace (``horizon`` periods)."""
        dev = resolve_device(device)
        if policy == "auto":
            policy = "amr2"
        _validate_config(policy=policy, arrivals=arrivals,
                         lp_method=lp_method)
        if faults is not None:
            raise _not_ported("chaos")
        if mobility is not None:
            raise _not_ported("mobility")
        if horizon <= 0:
            raise ValueError("horizon must be positive")
        if queue.n_devices != len(devices):
            raise ValueError("queue.n_devices must match the fleet size")
        qcls = np.asarray(queue.classes)
        key0 = None
        for d, spec in enumerate(devices):
            pcls = np.asarray(spec.profile.classes)
            if pcls.size > 1 and np.any(np.diff(pcls) <= 0):
                raise ValueError(
                    f"device {d} ({spec.profile.name}) profile classes "
                    f"{pcls.tolist()} must be strictly ascending")
            key = (tuple(pcls.tolist()), spec.profile.p_ed.shape[1])
            if key0 is None:
                key0 = key
            elif key != key0:
                raise ValueError(
                    "EngineParams.from_fleet needs a single shape group "
                    "(one class table and model count across the fleet); "
                    f"device {d} has {key}, device 0 has {key0}")
            missing = set(qcls.tolist()) - set(pcls.tolist())
            if missing:
                raise ValueError(
                    f"device {d} has no profile entry for queue classes "
                    f"{sorted(missing)}")
        lut = np.searchsorted(np.asarray(devices[0].profile.classes), qcls)
        if arrivals == "replay":
            counts, stream = queue.presample(horizon)
        else:
            counts = np.zeros((1, len(devices)), dtype=np.int64)
            stream = np.zeros((len(devices), 1), dtype=np.int32)
        probs = (np.full(len(qcls), 1.0 / len(qcls))
                 if queue.class_probs is None
                 else np.asarray(queue.class_probs, np.float64))
        arrays = dict(
            base_p_ed=np.stack([d.profile.p_ed[lut] for d in devices]),
            p_es=np.stack([d.profile.p_es[lut] for d in devices]),
            acc=np.stack([d.profile.acc for d in devices]),
            T=T, rate=np.asarray(queue.rate, np.float64), class_probs=probs,
            drift=np.array([[d.drift_at(t) for t in range(horizon)]
                            for d in devices]),
            outage=np.array([[d.outage_at(t) for t in range(horizon)]
                             for d in devices]),
            counts=counts, stream=stream)
        return params_from_arrays(
            arrays, dev, policy=policy, arrivals=arrivals,
            n_servers=n_servers, batch_max=queue.batch_max,
            straggler_threshold=straggler_threshold, ema=ema,
            frac_tol=frac_tol, iters=iters, maxiter=maxiter, tol=tol,
            lp_method=lp_method)

    @classmethod
    def from_config(cls, config, *, horizon: Optional[int] = None,
                    arrivals: str = "replay", policy: Optional[str] = None,
                    lp_method: Optional[str] = None,
                    device: DeviceLike = None) -> "EngineParams":
        """Build params from a `serving.FleetConfig` (the engine's twin of
        `FleetEngine.from_config`).  The replayed trace covers ``horizon``
        periods (default: the config's ``horizon``); ``lp_method``
        defaults to the config's.  The config's chaos, mobility and HI
        fields pass through the guards that raise while they are armed."""
        horizon = horizon if horizon is not None else config.horizon
        return cls.from_fleet(
            config.build_devices(), config.build_queue(), T=config.T,
            n_servers=config.n_servers,
            policy=policy if policy is not None else config.policy,
            horizon=horizon, arrivals=arrivals,
            straggler_threshold=config.straggler_threshold, ema=config.ema,
            lp_method=(lp_method if lp_method is not None
                       else getattr(config, "lp_method", "tableau")),
            faults=getattr(config, "faults", None),
            mobility=getattr(config, "mobility", None),
            device=device).with_hi(getattr(config, "hi", None))

    def with_hi(self, hi, **_kw) -> "EngineParams":
        """Online hierarchical inference: only disarming (``None``) is
        ported."""
        if hi is None:
            return self
        raise _not_ported("hi")

    def with_differentiable(self, enabled: bool = True,
                            **_kw) -> "EngineParams":
        """The differentiable rollout: only disarming is ported."""
        if not enabled:
            return self
        raise _not_ported("differentiable")


# dtypes of the EngineParams tensors; everything else is float64
_PARAM_DTYPES = {"outage": torch.bool, "counts": torch.int32,
                 "stream": torch.int32}
PARAM_ARRAYS = tuple(f.name for f in dataclasses.fields(EngineParams)
                     if f.type == "torch.Tensor")
PARAM_CONFIG = tuple(f.name for f in dataclasses.fields(EngineParams)
                     if f.type != "torch.Tensor")


def _validate_config(*, policy: str, arrivals: str, lp_method: str) -> None:
    if policy not in TRACEABLE_POLICIES:
        raise ValueError(
            f"policy={policy!r} has no batched engine path; the engine "
            f"supports {TRACEABLE_POLICIES}")
    if arrivals not in ("replay", "poisson"):
        raise ValueError(f"unknown arrivals mode {arrivals!r}")
    if lp_method not in ("tableau", "revised"):
        raise ValueError(f"unknown lp_method {lp_method!r}; expected "
                         f"'tableau' or 'revised'")


def params_from_arrays(arrays: Dict[str, object], device: torch.device,
                       **config) -> EngineParams:
    """`EngineParams` from NumPy arrays/scalars named like its tensor
    fields (`PARAM_ARRAYS`) plus config keywords (`PARAM_CONFIG`)."""
    missing = set(PARAM_ARRAYS) - set(arrays)
    if missing:
        raise ValueError(f"missing param arrays {sorted(missing)}")
    _validate_config(policy=config.get("policy", "amr2"),
                     arrivals=config.get("arrivals", "replay"),
                     lp_method=config.get("lp_method", "tableau"))
    tensors = {
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=_PARAM_DTYPES.get(name, torch.float64),
                           device=device)
        for name in PARAM_ARRAYS}
    return EngineParams(**tensors, **config)


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Everything a period mutates, as tensors on the params' device.

    ``seed`` takes the place of the reference's PRNG key: Poisson
    arrivals draw each period from generators seeded by (seed, period).
    The reference's positions and serving cells (mobility) and HI learner
    state belong to parts not ported yet and are not carried."""

    period: torch.Tensor       # () int32
    p_ed: torch.Tensor         # (D, c, m) belief latencies (audit state)
    pending: torch.Tensor      # (D,) int32 backlog counts
    head: torch.Tensor         # (D,) int32 replay-stream cursors
    warm_basis: torch.Tensor   # (D, R) int32 previous optimal bases (-1 cold)
    n_updates: torch.Tensor    # (D,) int32 straggler-audit update counts
    cell_load: torch.Tensor    # (1,) last period's admitted ES load
    p_es_belief: torch.Tensor  # (D, c) priced ES latencies
    seed: torch.Tensor         # () int64 Poisson arrival seed


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(EngineState))
_STATE_DTYPES = {"period": torch.int32, "pending": torch.int32,
                 "head": torch.int32, "warm_basis": torch.int32,
                 "n_updates": torch.int32, "seed": torch.int64}


def state_from_arrays(arrays: Dict[str, object],
                      device: torch.device) -> EngineState:
    """`EngineState` from NumPy arrays named like its fields."""
    missing = set(STATE_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing state arrays {sorted(missing)}")
    return EngineState(**{
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=_STATE_DTYPES.get(name, torch.float64),
                           device=device)
        for name in STATE_FIELDS})


@dataclasses.dataclass(frozen=True)
class PeriodMetrics:
    """One period's fleet-level numbers (0-d tensors; `rollout` stacks them
    into (periods,) tensors).  Every field of the reference is kept; the
    ones that belong to unported scenarios hold the values the reference
    gives with nothing armed (ladder counters 0, ``n_offload_ok ==
    n_offload_samples``, ``realized_makespan`` = the priced makespan)."""

    period: torch.Tensor
    n_jobs: torch.Tensor
    total_accuracy: torch.Tensor
    mean_job_accuracy: torch.Tensor
    n_violations: torch.Tensor
    worst_violation: torch.Tensor
    n_offloading: torch.Tensor
    n_backpressured: torch.Tensor
    n_outage: torch.Tensor
    n_straggler_updates: torch.Tensor
    n_unsolved: torch.Tensor
    es_utilization: torch.Tensor
    backlog: torch.Tensor
    n_offload_samples: torch.Tensor
    n_offload_ok: torch.Tensor
    n_deadline_miss: torch.Tensor
    n_retries: torch.Tensor
    n_fallback_local: torch.Tensor
    n_dropped: torch.Tensor
    realized_makespan: torch.Tensor
    n_es_audit_updates: torch.Tensor
    n_handover: torch.Tensor
    n_hi_offloaded: torch.Tensor
    n_hi_local_final: torch.Tensor
    hi_regret: torch.Tensor


METRIC_FIELDS = tuple(f.name for f in dataclasses.fields(PeriodMetrics))


def init_state(params: EngineParams, *, seed: int = 0,
               device: DeviceLike = None) -> EngineState:
    """A fresh fleet: beliefs = profiles, empty backlog, cold bases.
    ``seed`` (>= 0) seeds Poisson arrivals and is unused by replay."""
    if seed < 0:
        raise ValueError("seed must be >= 0")
    dev = _entry_device(params, None, device)
    D = params.n_devices
    i32 = dict(dtype=torch.int32, device=dev)
    return EngineState(
        period=torch.zeros((), **i32),
        p_ed=params.base_p_ed.clone(),
        pending=torch.zeros(D, **i32),
        head=torch.zeros(D, **i32),
        warm_basis=torch.full((D, params.n_basis_rows), -1, **i32),
        n_updates=torch.zeros(D, **i32),
        cell_load=torch.zeros(1, dtype=torch.float64, device=dev),
        p_es_belief=params.p_es.clone(),
        seed=torch.tensor(seed, dtype=torch.int64, device=dev))


# --------------------------------------------------------------------------
# period building blocks
# --------------------------------------------------------------------------
def _plan(params: EngineParams, fp: FleetProblem, warm_basis,
          lane_mask=None):
    """One batched solve of a padded `FleetProblem`.  amr2: the LP
    relaxation (warm-or-cold simplex) and its rounding; dual: the
    bisection over every lane (``lane_mask`` unused), no basis, status 0
    ok and 1 fallback.  Returns ``(assignment (D, n) int32, status (D,)
    int32, basis (D, R) int32)``; under dual the basis is ``warm_basis``
    or, without one, all -1.  (The reference's CPU lane chunking,
    `REPRO_PLAN_LANE_CHUNK`, is bitwise-invisible and has no counterpart
    here.)"""
    D, n = fp.p_es.shape
    m = fp.p_ed.shape[2]
    if params.policy == "dual":
        assign, st = dual_one_batch(fp.p_ed, fp.p_es, fp.acc, fp.T,
                                    iters=params.iters)
        basis = (warm_basis.to(torch.int32) if warm_basis is not None
                 else torch.full((D, params.n_basis_rows), -1,
                                 dtype=torch.int32, device=fp.p_ed.device))
        return assign.to(torch.int32), st.to(torch.int32), basis
    A, b, c_full = build_lp_arrays_torch(fp.p_ed, fp.p_es, fp.acc, fp.T)
    maxiter = params.maxiter if params.maxiter is not None else \
        _bucket_maxiter(50 * (A.shape[1] + 2))
    x, _fun, st, _ni, basis, _ok = simplex_batch_core(
        A, b, c_full, warm_basis, nv=n * (m + 1), maxiter=maxiter,
        tol=params.tol, lane_mask=lane_mask, method=params.lp_method)
    assign, sched_status, _nf = round_relaxation_torch(
        fp.p_ed, fp.p_es, fp.acc, fp.T, x.reshape(D, n, m + 1), st,
        frac_tol=params.frac_tol)
    return assign, sched_status, basis.to(torch.int32)


def _recover_unsolved(assign, unsolved, p_ed_jobs, mask, acc, T):
    """Greedy local-only plan for ``unsolved`` lanes (LP at the iteration
    cap or unbounded): largest local model fitting the residual budget, in
    job order, and the fastest local model where none fits.  Solved lanes
    pass through untouched."""
    D, _n, m = p_ed_jobs.shape
    eligible = unsolved[:, None] & mask
    choice, fit, _ = greedy_local_fill(p_ed_jobs, acc[:, :m], T.expand(D),
                                       eligible)
    cheapest = p_ed_jobs.argmin(dim=2).to(torch.int32)
    local = torch.where(fit, choice, cheapest)
    return torch.where(eligible, local, assign).to(torch.int32)


def _generator(seed: int, period: int, stream: int,
               device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, period, stream)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(
        [seed, period, stream]).generate_state(1, np.uint64)[0]))
    return g


def _slot_sum(x):
    """Sum (D, n) over the job slots in slot order.  `torch.sum`
    associates differently on the CPU and the card, and devices whose ES
    demands tie in exact arithmetic (the same jobs in other slots) would
    then be admitted in another order; the same additions in the same
    order agree bit for bit."""
    out = x[:, 0]
    for k in range(1, x.shape[1]):
        out = out + x[:, k]
    return out


def _arrivals(state: EngineState, params: EngineParams, t: int):
    """Release this period's jobs: ``(ci (D, n) int32 class indices,
    take (D,) int32, pending', head')``.  Replay reads the trace; Poisson
    draws the whole fleet's counts and the classes of every release slot
    (a backlogged job takes a fresh class when it is released, which is
    the same distribution for i.i.d. classes)."""
    n = params.batch_max
    dev = params.device
    D = params.n_devices
    if params.arrivals == "poisson":
        seed = int(state.seed)
        counts_t = torch.poisson(params.rate,
                                 generator=_generator(seed, t, 0, dev))
        avail = state.pending + counts_t.to(torch.int32)
        take = torch.clamp_max(avail, n).to(torch.int32)
        ci = torch.multinomial(params.class_probs, D * n, replacement=True,
                               generator=_generator(seed, t, 1, dev))
        return (ci.reshape(D, n).to(torch.int32), take,
                (avail - take).to(torch.int32), state.head)
    counts_t = params.counts[t % params.counts.shape[0]]
    avail = state.pending + counts_t
    take = torch.clamp_max(avail, n).to(torch.int32)
    S = params.stream.shape[1]
    idx = state.head[:, None] + torch.arange(n, dtype=torch.int32,
                                             device=dev)[None, :]
    ci = torch.gather(params.stream, 1, idx.clamp(0, S - 1).long())
    head = (state.head + take).to(torch.int32)
    return ci, take, (avail - take).to(torch.int32), head


def _period(belief_p_ed, warm_basis, ci, take, drift_t, outage_t,
            es_tbl, params: EngineParams):
    """Everything after arrivals and before the state bookkeeping (the
    base branch of the reference's `_period_impl`), shared by `step` and
    the host `FleetEngine`'s delegation.  Returns ``(new_belief,
    new_warm_basis, upd (D,) bool, factor (D,), cell_load (1,), metrics
    dict)``; ``factor`` is the EMA rescale each updated device's belief
    was multiplied by (the delegation applies it to its profile tables).
    Only amr2 carries a basis forward; dual hands ``warm_basis`` back."""
    D, _c, m = belief_p_ed.shape
    n = params.batch_max
    dev = belief_p_ed.device
    f64 = torch.float64
    mask = torch.arange(n, device=dev)[None, :] < take[:, None]
    rows = torch.arange(D, device=dev)[:, None]
    ci = ci.clamp(0, params.p_es.shape[1] - 1)
    p_ed_jobs = torch.where(mask[..., None], belief_p_ed[rows, ci], 0.0)
    base_jobs = torch.where(mask[..., None], params.base_p_ed[rows, ci], 0.0)
    p_es_jobs = torch.where(mask, es_tbl[rows, ci], 0.0)
    p_es_jobs = torch.where(outage_t[:, None] & mask, ES_DISABLED_SENTINEL,
                            p_es_jobs)
    Tvec = params.T.expand(D)
    fp = FleetProblem.from_arrays_unchecked(p_ed_jobs, p_es_jobs,
                                            params.acc, Tvec, mask)

    # ---- plan the whole fleet in one batched solve ----------------------
    assign, status, basis = _plan(params, fp, warm_basis)
    unsolved_lane = status == ST_UNSOLVED
    n_unsolved = unsolved_lane.to(torch.int32)
    assign = _recover_unsolved(assign, unsolved_lane, p_ed_jobs, mask,
                               params.acc, params.T)

    # ---- ES-pool admission ---------------------------------------------
    demand = _slot_sum(torch.where(mask & (assign == m), p_es_jobs, 0.0))
    admitted, loads, _inc = admit_mask_pool(demand, params.T,
                                            params.n_servers)
    offl = demand > 0
    bumped = offl & ~admitted

    # ---- backpressure: lane-masked ES-disabled replan -------------------
    # skipped on no-bump periods; cold (no basis to factor) and only the
    # bumped lanes pivot
    if bool(bumped.any()):
        p_es_crippled = torch.where(mask, ES_DISABLED_SENTINEL, 0.0)
        fp_bp = FleetProblem.from_arrays_unchecked(
            p_ed_jobs, p_es_crippled, params.acc, Tvec, mask)
        assign_bp, st_bp, _ = _plan(
            params, fp_bp, None,
            lane_mask=bumped if params.policy == "amr2" else None)
        unsolved_bp = bumped & (st_bp == ST_UNSOLVED)
        assign_bp = _recover_unsolved(assign_bp, unsolved_bp, p_ed_jobs,
                                      mask, params.acc, params.T)
        assign = torch.where(bumped[:, None], assign_bp, assign)
        n_unsolved = n_unsolved + unsolved_bp.to(torch.int32)

    # ---- pricing, violations, straggler audit ---------------------------
    acc_jobs = params.acc[rows, assign]
    i32 = torch.int32
    n_jobs = mask.sum().to(i32)
    on_ed = mask & (assign < m)
    picked = assign.clamp(0, m - 1).long()[..., None]
    ed_pred = torch.where(on_ed, torch.gather(p_ed_jobs, 2, picked)[..., 0],
                          0.0).sum(dim=1)
    ed_wall = torch.where(on_ed, torch.gather(base_jobs, 2, picked)[..., 0],
                          0.0).sum(dim=1) * drift_t
    es_wall = torch.where(admitted, demand, 0.0)
    es_samp = mask & (assign == m)          # admitted offloads (post-replan)
    total_acc = torch.where(mask, acc_jobs, 0.0).sum()
    wall = torch.maximum(ed_wall, es_wall)
    viol = torch.clamp_min(wall / params.T - 1.0, 0.0)

    ratio = ed_wall / torch.clamp_min(ed_pred, 1e-9)
    upd = (ed_pred > 0) & (ratio > params.straggler_threshold)
    factor = (1.0 - params.ema) + params.ema * ratio
    new_belief = torch.where(upd[:, None, None],
                             belief_p_ed * factor[:, None, None],
                             belief_p_ed)

    n_off = es_samp.sum().to(i32)
    zero_i = torch.zeros((), dtype=i32, device=dev)

    metrics = {
        "n_jobs": n_jobs,
        "total_accuracy": total_acc,
        "n_violations": (viol > 0).sum().to(i32),
        "worst_violation": torch.clamp_min(viol.amax(), 0.0),
        "n_offloading": offl.sum().to(i32),
        "n_backpressured": bumped.sum().to(i32),
        "n_outage": outage_t.sum().to(i32),
        "n_straggler_updates": upd.sum().to(i32),
        "n_unsolved": n_unsolved.sum().to(i32),
        "es_utilization": loads.sum() / (params.n_servers * params.T),
        "realized_makespan": torch.clamp_min(wall.amax(), 0.0),
        "n_offload_samples": n_off, "n_offload_ok": n_off,
        "n_deadline_miss": zero_i, "n_retries": zero_i,
        "n_fallback_local": zero_i, "n_dropped": zero_i,
        "n_es_audit_updates": zero_i,
        "n_hi_offloaded": zero_i, "n_hi_local_final": zero_i,
        "hi_regret": torch.zeros((), dtype=f64, device=dev),
    }
    new_warm = basis if params.policy == "amr2" else warm_basis
    return new_belief, new_warm, upd, factor, loads.sum()[None], metrics


def _step(state: EngineState, params: EngineParams
          ) -> Tuple[EngineState, PeriodMetrics]:
    """One period: arrivals, `_period`, state and metric assembly."""
    t = int(state.period)
    H = params.drift.shape[1]
    drift_t = params.drift[:, t % H]
    outage_t = params.outage[:, t % H]
    # a basis optimal for last period's LP is meaningless when the ES
    # column set changed underneath it (outage flipped on/off): cold-start
    # those lanes
    if t > 0:
        stale = params.outage[:, (t - 1) % H] != outage_t
        warm0 = torch.where(stale[:, None], -1, state.warm_basis)
    else:
        warm0 = state.warm_basis
    ci, take, pending, head = _arrivals(state, params, t)
    new_belief, new_warm, upd, _factor, cell_load, m = _period(
        state.p_ed, warm0, ci, take, drift_t, outage_t, state.p_es_belief,
        params)
    n_jobs = m["n_jobs"]
    metrics = PeriodMetrics(
        period=state.period.clone(),
        mean_job_accuracy=torch.where(
            n_jobs > 0, m["total_accuracy"] / torch.clamp_min(n_jobs, 1),
            0.0),
        backlog=pending.sum().to(torch.int32),
        n_handover=torch.zeros((), dtype=torch.int32, device=params.device),
        **m)
    new_state = EngineState(
        period=state.period + 1, p_ed=new_belief, pending=pending,
        head=head, warm_basis=new_warm.to(torch.int32),
        n_updates=(state.n_updates + upd.to(torch.int32)),
        cell_load=cell_load, p_es_belief=state.p_es_belief,
        seed=state.seed)
    return new_state, metrics


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def _require_f64(tag: str, obj) -> None:
    """Reject floating tensors that are not float64 instead of computing
    with them: the engine is float64 end to end (the LP parity contract)."""
    for f in dataclasses.fields(obj):
        leaf = getattr(obj, f.name)
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and leaf.dtype != torch.float64):
            raise TypeError(f"{tag}.{f.name} is {leaf.dtype} but the engine "
                            f"is float64-only; build tensors as float64")


def _tensors(obj) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _entry_device(params: EngineParams, state: Optional[EngineState],
                  device: DeviceLike) -> torch.device:
    """Resolve the call's device (CUDA unless named) and check that params
    and state live there."""
    dev = resolve_device(device)
    check_device("params", _tensors(params), dev)
    if state is not None:
        check_device("state", _tensors(state), dev)
    return dev


def _check_horizon(state: EngineState, params: EngineParams,
                   periods: int) -> None:
    if params.arrivals != "replay":
        return
    end = int(state.period) + periods
    if end > params.counts.shape[0]:
        raise ValueError(
            f"replayed arrival trace covers {params.counts.shape[0]} "
            f"periods but the rollout needs {end}; presample a longer "
            f"horizon (EngineParams.from_fleet(..., horizon=)) or use "
            f"arrivals='poisson'")


def _checked(state, params, periods, device) -> None:
    _entry_device(params, state, device)
    _require_f64("state", state)
    _require_f64("params", params)
    _check_horizon(state, params, periods)


def step(state: EngineState, params: EngineParams, *,
         device: DeviceLike = None) -> Tuple[EngineState, PeriodMetrics]:
    """One period transition (float64)."""
    _checked(state, params, 1, device)
    return _step(state, params)


def rollout(state: EngineState, params: EngineParams, periods: int, *,
            device: DeviceLike = None
            ) -> Tuple[EngineState, PeriodMetrics]:
    """``periods`` consecutive steps.  Returns ``(final_state, metrics)``
    with every `PeriodMetrics` field stacked to a (periods,) tensor."""
    _checked(state, params, periods, device)
    history = []
    for _ in range(int(periods)):
        state, m = _step(state, params)
        history.append(m)
    return state, PeriodMetrics(**{
        f: torch.stack([getattr(m, f) for m in history])
        for f in METRIC_FIELDS})


def fleet_mesh(*_args, **_kwargs):
    raise _not_ported("sharded")


def shard(*_args, **_kwargs):
    raise _not_ported("sharded")


def step_sharded(*_args, **_kwargs):
    raise _not_ported("sharded")


def rollout_sharded(*_args, **_kwargs):
    raise _not_ported("sharded")
