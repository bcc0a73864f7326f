"""Fleet-scale serving: N edge devices, one ES pool, one period at a time
(port of `repro.serving.fleet`).

* Fleet construction — `DeviceSpec`, `paper_style_profile`,
  `roofline_style_profile`, `make_fleet`.  The NumPy draws happen in the
  reference's order, so with the same seed and the same ES constants the
  port's fleet equals the reference's.  The ES tier's peak FLOP/s and
  bytes/s have no default: the reference's defaults are TPU v5e figures,
  and a caller of the port states its own.
* `FleetEngine` — the host period pipeline (the reference's
  `_run_period_host`).  Each period it polls the `RequestQueue`,
  assembles one padded `FleetProblem` per profile-shape group, plans it
  with `api.solve` (under ``policy="auto"``: AMDP's DP for identical-job
  devices, batched AMR^2 for the rest; both on the card), admits the
  offload demand to the `EdgeServerPool`, replans the devices admission
  bumped in one ES-disabled solve, and prices the plan and runs the EMA
  straggler audit on the host, in NumPy, as the reference does.

Not ported yet: the reference's delegation of single-group amr2/dual
fleets to the traced engine (with its `UnsolvedPeriodError`),
`run_period_reference`, `FleetConfig` / `from_config`, and the chaos and
hierarchical-inference scenarios; asking for them raises
`NotImplementedError` naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from .._device import DeviceLike, resolve_device
from ..api.front import batched_policies, solve
from ..api.registry import get_solver
from ..core.instances import (PAPER_ACC, PAPER_COMM, PAPER_P_ED,
                              PAPER_P_ES_PROC)
from ..core.problem import ES_DISABLED_SENTINEL, FleetProblem, Problem
from .profile import TierProfile, roofline_profile
from .queue import RequestQueue

_NOT_PORTED = {
    "delegate": "FleetEngine's delegation of a one-group amr2/dual fleet "
                "to the traced engine is not ported yet (ROADMAP §1 item 7); "
                "pass delegate=False for the host period pipeline, or run "
                "repro_torch.api.engine.rollout",
    "faults": "the chaos scenario is not ported yet (ROADMAP §1 item 9)",
    "hi": "online hierarchical inference is not ported yet (ROADMAP §1 "
          "item 9)",
}


@dataclasses.dataclass
class DeviceSpec:
    """One edge device: its believed latency `profile`, the true per-period
    ED slowdown factors `drift` (cycled, 1.0 = nominal) and the periods
    its ES link is down (`outage`)."""
    profile: TierProfile
    drift: Optional[np.ndarray] = None
    outage: Optional[np.ndarray] = None
    name: str = ""

    def drift_at(self, period: int) -> float:
        if self.drift is None or len(self.drift) == 0:
            return 1.0
        return float(self.drift[period % len(self.drift)])

    def outage_at(self, period: int) -> bool:
        if self.outage is None or len(self.outage) == 0:
            return False
        return bool(self.outage[period % len(self.outage)])


def paper_style_profile(rng: np.random.Generator,
                        classes: Sequence[int] = (128, 512, 1024)
                        ) -> TierProfile:
    """The paper's Raspberry-Pi/ResNet50 testbed numbers with per-device
    jitter."""
    jit_ed = rng.uniform(0.8, 1.3, size=(len(classes), 2))
    jit_es = rng.uniform(0.9, 1.2, size=len(classes))
    p_ed = np.array([PAPER_P_ED[c] for c in classes]) * jit_ed
    p_es = np.array([PAPER_COMM[c] + PAPER_P_ES_PROC[c]
                     for c in classes]) * jit_es
    return TierProfile(name="paper-jittered", p_ed=p_ed, p_es=p_es,
                       acc=PAPER_ACC.copy(), classes=list(classes))


def roofline_style_profile(rng: np.random.Generator,
                           classes: Sequence[int] = (128, 512, 1024), *,
                           es_peak_flops: float, es_hbm_bw: float
                           ) -> TierProfile:
    """A roofline-derived device: LM-ladder latencies from analytic
    compute/memory terms, scaled to the paper's regime; the ES tier runs
    at ``es_peak_flops`` / ``es_hbm_bw``."""
    dims = np.asarray(classes, np.float64)
    flops = 4e9 * (dims / dims[0])                  # per-request useful flops
    acts = 6e7 * (dims / dims[0])                   # activation traffic bytes
    payload = 3.0 * dims ** 2                       # image-ish upload bytes
    derate = rng.uniform(0.7, 1.4)
    return roofline_profile(
        "roofline", list(classes),
        flops_per_class=flops, bytes_per_class=acts,
        model_scales=(0.25, 0.75), acc=(0.42, 0.58, 0.78),
        payload_bytes=payload,
        ed_peak_flops=1.2e12 * derate, ed_hbm_bw=40e9 * derate,
        es_peak_flops=es_peak_flops, es_hbm_bw=es_hbm_bw,
        link_gbps=0.08)


def make_fleet(n_devices: int, *, es_peak_flops: float, es_hbm_bw: float,
               classes: Sequence[int] = (128, 512, 1024),
               roofline_frac: float = 0.5, straggler_frac: float = 0.25,
               outage_frac: float = 0.1, drift_mag: float = 3.0,
               horizon: int = 64, seed: int = 0) -> List[DeviceSpec]:
    """A heterogeneous fleet mixing paper-style and roofline-derived
    devices, with `straggler_frac` of them drifting to `drift_mag x`
    slowdown partway through the horizon and `outage_frac` suffering
    ES-link outages.  ``es_peak_flops`` / ``es_hbm_bw`` describe the ES
    silicon of the roofline-derived devices."""
    rng = np.random.default_rng(seed)
    specs: List[DeviceSpec] = []
    for d in range(n_devices):
        if rng.uniform() < roofline_frac:
            prof = roofline_style_profile(rng, classes,
                                          es_peak_flops=es_peak_flops,
                                          es_hbm_bw=es_hbm_bw)
        else:
            prof = paper_style_profile(rng, classes)
        drift = None
        if rng.uniform() < straggler_frac:
            onset = rng.integers(1, max(2, horizon // 2))
            drift = np.ones(horizon)
            drift[onset:] = drift_mag
        outage = None
        if rng.uniform() < outage_frac:
            outage = rng.uniform(size=horizon) < 0.2
        specs.append(DeviceSpec(profile=prof, drift=drift, outage=outage,
                                name=f"dev{d}"))
    return specs


# --------------------------------------------------------------------------
# the host period pipeline
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _DeviceState:
    spec: DeviceSpec
    profile: TierProfile        # current belief (EMA-updated on stragglers)
    n_updates: int = 0


class _ShapeGroup:
    """Every device sharing one (classes, m) profile shape, as stacked
    belief/base latency tables, so a period's assembly, pricing and audit
    are whole-group array operations."""

    def __init__(self, ids: Sequence[int], states: Sequence[_DeviceState]):
        self.ids = np.asarray(ids, dtype=np.int64)
        self.classes = np.asarray(states[0].profile.classes)
        self.p_ed = np.stack([st.profile.p_ed for st in states]
                             ).astype(np.float64)          # belief (D, c, m)
        self.p_es = np.stack([st.profile.p_es for st in states]
                             ).astype(np.float64)          # (D, c)
        self.acc = np.stack([st.profile.acc for st in states]
                            ).astype(np.float64)           # (D, m+1)
        self.base_p_ed = np.stack([st.spec.profile.p_ed for st in states]
                                  ).astype(np.float64)     # truth (D, c, m)
        # last period's optimal simplex bases (D, R) of LP-planned devices
        # (-1 rows elsewhere), fed back as `solve(..., warm_start=)`
        self.warm_basis: Optional[np.ndarray] = None

    @property
    def m(self) -> int:
        return self.p_ed.shape[2]


@dataclasses.dataclass
class FleetPeriodStats:
    period: int
    n_devices: int
    n_jobs: int                 # real (non-phantom) jobs planned
    plan_seconds: float         # wall time spent planning the whole fleet
    total_accuracy: float
    mean_job_accuracy: float
    n_violations: int           # devices whose wall makespan exceeded T
    worst_violation: float      # max over devices of makespan/T - 1
    n_offloading: int           # devices that planned ES work
    n_backpressured: int        # devices bumped off the ES pool
    n_outage: int
    n_straggler_updates: int
    es_utilization: float       # admitted demand / (n_servers * T)
    backlog: int                # jobs still queued after this period
    # realized execution: fault-free periods report n_offload_ok ==
    # n_offload_samples, zero ladder counters, and realized_makespan ==
    # the priced fleet makespan (the chaos scenario is not ported)
    n_offload_samples: int = 0
    n_offload_ok: int = 0
    n_deadline_miss: int = 0
    n_retries: int = 0
    n_fallback_local: int = 0
    n_dropped: int = 0
    realized_makespan: float = 0.0
    n_es_audit_updates: int = 0
    # online hierarchical inference (not ported): zeros
    n_hi_offloaded: int = 0
    n_hi_local_final: int = 0
    hi_regret: float = 0.0


class EdgeServerPool:
    """``n_servers`` ES tiers, each offering T seconds per period.
    Admission is greedy — ascending demand (device id on ties),
    least-loaded server first — so every admitted server load respects
    the paper's constraint (2); it is not an optimal bin packing."""

    def __init__(self, n_servers: int):
        if n_servers <= 0:
            raise ValueError("n_servers must be positive")
        self.n_servers = n_servers

    def admit_mask(self, demands: np.ndarray, T: float):
        """``demands`` (D,) ES seconds per device (<= 0: not offloading).
        Returns ``(admitted (D,) bool, per-server loads)``."""
        demands = np.asarray(demands, dtype=np.float64)
        eff = np.where(demands > 0, demands, np.inf)
        order = np.argsort(eff, kind="stable")       # ties -> id order
        loads = np.zeros(self.n_servers)
        mask = np.zeros(len(demands), dtype=bool)
        for d in order:
            need = float(demands[d])
            if need <= 0:        # the +inf tail: non-offloaders
                break
            slot = int(np.argmin(loads))
            if loads[slot] + need <= T + 1e-12:
                loads[slot] += need
                mask[d] = True
        return mask, loads


class FleetEngine:
    """Drives the whole fleet, one period at a time, on the host period
    pipeline; the LP and the DP of each period's solves run on
    ``device`` (the CUDA card unless named)."""

    def __init__(self, devices: Sequence[DeviceSpec], queue: RequestQueue, *,
                 n_servers: int = 1, T: float, policy: str = "auto",
                 straggler_threshold: float = 1.5, ema: float = 0.5,
                 delegate: bool = True, faults=None, hi=None,
                 device: DeviceLike = None):
        if queue.n_devices != len(devices):
            raise ValueError("queue.n_devices must match the fleet size")
        if policy != "auto" and get_solver(policy).info.bound_only:
            raise ValueError(                     # get_solver rejects unknowns
                f"policy={policy!r} is a bound-only solver; its "
                f"assignments need not satisfy the budgets, so it "
                f"cannot drive the serving engine")
        for d, spec in enumerate(devices):
            cls = np.asarray(spec.profile.classes)
            if cls.size > 1 and np.any(np.diff(cls) <= 0):
                raise ValueError(
                    f"device {d} ({spec.profile.name}) profile classes "
                    f"{cls.tolist()} must be strictly ascending")
            missing = set(np.asarray(queue.classes).tolist()) \
                - set(cls.tolist())
            if missing:
                raise ValueError(
                    f"device {d} ({spec.profile.name}) has no profile entry "
                    f"for queue classes {sorted(missing)}")
        if faults is not None:
            raise NotImplementedError(_NOT_PORTED["faults"])
        if hi is not None:
            raise NotImplementedError(_NOT_PORTED["hi"])
        self.devices = [_DeviceState(spec=d, profile=d.profile)
                        for d in devices]
        self.queue = queue
        self.pool = EdgeServerPool(n_servers)
        self.T = T
        self.policy = policy
        # a solver without a batched path (greedy) plans device by device
        self._batched = policy in batched_policies()
        self.straggler_threshold = straggler_threshold
        self.ema = ema
        self.device = resolve_device(device)
        self.history: List[FleetPeriodStats] = []
        # per period: how many devices each solver planned, in the plan
        # and in the backpressure replan
        self.solver_log: List[Dict[str, Counter]] = []
        self._period = 0
        by_key: Dict[tuple, List[int]] = {}
        for d, st in enumerate(self.devices):
            key = (tuple(np.asarray(st.profile.classes).tolist()),
                   st.profile.p_ed.shape[1])
            by_key.setdefault(key, []).append(d)
        self._groups = [_ShapeGroup(ids, [self.devices[d] for d in ids])
                        for ids in by_key.values()]
        if delegate and policy in ("amr2", "dual") \
                and len(self._groups) == 1:
            raise NotImplementedError(_NOT_PORTED["delegate"])

    def run(self, periods: int) -> List[FleetPeriodStats]:
        """Run ``periods`` periods."""
        return [self.run_period() for _ in range(periods)]

    def run_period(self) -> FleetPeriodStats:
        """One period of the host pipeline: arrivals, batched solves,
        admission, backpressure replans, pricing and the audit."""
        t = self._period
        self._period += 1
        arrivals = self.queue.poll(t)
        n_pad = self.queue.batch_max
        D_all = len(self.devices)
        outage = np.fromiter((st.spec.outage_at(t) for st in self.devices),
                             dtype=bool, count=D_all)
        drift = np.fromiter((st.spec.drift_at(t) for st in self.devices),
                            dtype=np.float64, count=D_all)
        log = {"plan": Counter(), "replan": Counter()}

        plan_seconds = 0.0
        staged = []                   # (group, fleet problem, base, assign)
        es_demand_all = np.zeros(D_all)
        stale_all = None
        if t > 0:
            prev = np.fromiter(
                (st.spec.outage_at(t - 1) for st in self.devices),
                dtype=bool, count=D_all)
            stale_all = prev != outage     # the ES column set changed: the
            #                                carried basis labels another
            #                                LP — cold-start those lanes
        for g in self._groups:
            fp, base = self._assemble(g, arrivals, outage, n_pad)
            warm = {}
            if g.warm_basis is not None:
                wb = np.asarray(g.warm_basis)
                if stale_all is not None:
                    wb = np.where(stale_all[g.ids][:, None], -1, wb)
                warm["warm_start"] = wb
            sol = solve(fp, policy=self.policy, device=self.device, **warm)
            # LP-planned rows warm the next period; a period with no LP
            # solve drops the carry rather than hand it to a later one
            g.warm_basis = None if sol.basis is None \
                else np.asarray(sol.basis)
            plan_seconds += sol.plan_seconds
            log["plan"].update(str(s) for s in np.atleast_1d(sol.solver))
            assign = sol.assignment
            es_demand_all[g.ids] = sol.es_makespan
            staged.append((g, fp, base, assign))

        # --- ES capacity: admit offload demand server by server ----------
        offl_mask = es_demand_all > 0
        admitted_mask, loads = self.pool.admit_mask(es_demand_all, self.T)
        bumped = np.nonzero(offl_mask & ~admitted_mask)[0]
        n_offloading = int(offl_mask.sum())

        # --- backpressure: ONE ES-disabled replan per group --------------
        for g, fp, base, assign in staged:
            rows = np.nonzero(np.isin(g.ids, bumped))[0]
            if not len(rows):
                continue
            if self._batched:
                fb = solve(fp.take(rows), policy=self.policy,
                           es_disabled=True, device=self.device)
                plan_seconds += fb.plan_seconds
                log["replan"].update(str(s) for s in np.atleast_1d(fb.solver))
                assign[rows] = fb.assignment
            else:                     # device by device, stripped
                t0 = time.perf_counter()
                mask = fp.real_mask
                for r in rows:
                    k = int(mask[r].sum())
                    stripped = Problem(
                        p_ed=fp.p_ed[r, :k], p_es=fp.p_es[r, :k],
                        acc=fp.acc[r], T=self.T)
                    fbp = solve(stripped, policy=self.policy,
                                es_disabled=True, device=self.device)
                    log["replan"][str(fbp.solver)] += 1
                    assign[r, :k] = fbp.assignment
                plan_seconds += time.perf_counter() - t0

        # --- pricing, accounting and the straggler audit ------------------
        n_jobs = 0
        total_acc = 0.0
        worst_viol = 0.0
        n_viol = 0
        n_updates = 0
        n_off_samples = 0
        realized_makespan = 0.0
        for g, fp, base, assign in staged:
            m = g.m
            mask = fp.real_mask
            n_jobs += int(mask.sum())
            # fault-free execution: every admitted offload completes
            n_off_samples += int((mask & (assign == m)).sum())
            acc_jobs = fp.acc[np.arange(len(g.ids))[:, None], assign]
            total_acc += float(np.where(mask, acc_jobs, 0.0).sum())

            on_ed = mask & (assign < m)
            picked = np.clip(assign, 0, m - 1)[..., None]
            ed_pred = np.where(
                on_ed, np.take_along_axis(fp.p_ed, picked, axis=2)[..., 0],
                0.0).sum(axis=1)
            # ground truth: the device's BASE latencies times its true
            # drift (against the EMA belief the audit would compound)
            ed_wall = np.where(
                on_ed, np.take_along_axis(base, picked, axis=2)[..., 0],
                0.0).sum(axis=1) * drift[g.ids]
            es_wall = np.where(admitted_mask[g.ids], es_demand_all[g.ids],
                               0.0)
            wall = np.maximum(ed_wall, es_wall)
            realized_makespan = max(realized_makespan,
                                    float(wall.max(initial=0.0)))
            viol = np.maximum(0.0, wall / self.T - 1.0)
            worst_viol = max(worst_viol, float(viol.max(initial=0.0)))
            n_viol += int((viol > 0).sum())

            ratio = ed_wall / np.maximum(ed_pred, 1e-9)
            upd = (ed_pred > 0) & (ratio > self.straggler_threshold)
            if upd.any():
                factor = (1 - self.ema) + self.ema * ratio
                g.p_ed[upd] *= factor[upd, None, None]
                for r in np.nonzero(upd)[0]:
                    st = self.devices[int(g.ids[r])]
                    st.profile = dataclasses.replace(
                        st.profile, p_ed=g.p_ed[r].copy())
                    st.n_updates += 1
                n_updates += int(upd.sum())

        stats = FleetPeriodStats(
            period=t, n_devices=D_all, n_jobs=n_jobs,
            plan_seconds=plan_seconds, total_accuracy=total_acc,
            mean_job_accuracy=total_acc / n_jobs if n_jobs else 0.0,
            n_violations=n_viol, worst_violation=worst_viol,
            n_offloading=n_offloading, n_backpressured=len(bumped),
            n_outage=int(outage.sum()), n_straggler_updates=n_updates,
            es_utilization=float(loads.sum()) / (self.pool.n_servers
                                                 * self.T),
            backlog=self.queue.backlog,
            n_offload_samples=n_off_samples, n_offload_ok=n_off_samples,
            realized_makespan=realized_makespan)
        self.history.append(stats)
        self.solver_log.append(log)
        return stats

    def _assemble(self, g: _ShapeGroup, arrivals, outage: np.ndarray,
                  n_pad: int):
        """One group's padded `FleetProblem` as masked array gathers.
        Returns ``(fleet problem, base ED latencies)``."""
        D = len(g.ids)
        lens = np.fromiter((len(arrivals[d]) for d in g.ids),
                           dtype=np.int64, count=D)
        mask = np.arange(n_pad)[None, :] < lens[:, None]
        cls = np.full((D, n_pad), g.classes[0],
                      dtype=np.asarray(self.queue.classes).dtype)
        if lens.sum():
            cls[mask] = np.concatenate(
                [arrivals[d] for d in g.ids if len(arrivals[d])])
        ci = np.searchsorted(g.classes, cls)
        rows = np.arange(D)[:, None]
        p_ed = g.p_ed[rows, ci]
        p_es = g.p_es[rows, ci]
        base = g.base_p_ed[rows, ci]
        p_ed[~mask] = 0.0
        p_es[~mask] = 0.0
        base[~mask] = 0.0
        p_es[outage[g.ids][:, None] & mask] = ES_DISABLED_SENTINEL
        fp = FleetProblem(p_ed=p_ed, p_es=p_es, acc=g.acc.copy(),
                          T=np.full(D, self.T), real_mask=mask)
        return fp, base

    def summary(self) -> Dict[str, float]:
        h = self.history
        if not h:
            return {}
        jobs = sum(s.n_jobs for s in h)
        return {
            "periods": len(h),
            "jobs": jobs,
            "mean_job_accuracy": (sum(s.total_accuracy for s in h) / jobs
                                  if jobs else 0.0),
            "violation_rate": sum(s.n_violations for s in h) / (
                len(h) * len(self.devices)),
            "backpressure_rate": sum(s.n_backpressured for s in h) / (
                len(h) * len(self.devices)),
            "plan_seconds_per_period": (sum(s.plan_seconds for s in h)
                                        / len(h)),
            "devices_per_second": (len(self.devices) * len(h)
                                   / max(sum(s.plan_seconds for s in h),
                                         1e-12)),
            "straggler_updates": sum(s.n_straggler_updates for s in h),
            "final_backlog": h[-1].backlog,
        }
