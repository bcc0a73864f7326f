"""Fleet-scale serving: N edge devices, one ES pool, one period at a time
(port of `repro.serving.fleet`).

* Fleet construction — `DeviceSpec`, `paper_style_profile`,
  `roofline_style_profile`, `make_fleet`, and the declarative
  `FleetConfig` (`FleetEngine.from_config`).  The NumPy draws happen in
  the reference's order, so with the same seed and the same ES constants
  the port's fleet equals the reference's.  The ES tier's peak FLOP/s and
  bytes/s have no default: the reference's defaults are TPU v5e figures,
  and a caller of the port states its own.
* `FleetEngine` — the period loop.  A fleet of one profile-shape group
  under ``policy="amr2"`` or ``"dual"`` with ``delegate=True`` (and the
  torch backend) hands each period to the tensor engine's period core
  (`api.engine._period`) on ``device``: the host only polls the queue,
  maps arrival values to class indices and books the stats, so `run(P)`
  equals `api.engine.rollout` of the same config bit for bit, the chaos
  and HI scenarios included (``faults=``, ``hi=``: the host threads the
  audited ES belief, the HI learner and each period's draws as the
  rollout does).  A period
  that leaves LP lanes unsolved raises `UnsolvedPeriodError` (or warns
  under ``strict="warn"``).  Every other fleet runs the host period
  pipeline (the reference's `_run_period_host`): per shape group one
  padded `FleetProblem` planned with `api.solve` (under
  ``policy="auto"``: AMDP's DP for identical-job devices, batched AMR^2
  for the rest), admission to the `EdgeServerPool`, one ES-disabled
  replan of the bumped devices, and pricing and the EMA straggler audit
  on the host, in NumPy, as the reference does.  ``backend="numpy"``
  plans with the sequential NumPy oracles instead of the card.
* `run_period_reference` — the reference's per-device loop (padding,
  stripping, sequential replans, per-device audit), the oracle and
  baseline the array-resident loop is held to.

Chaos and HI need the delegation (an armed model on the host pipeline
raises `ValueError`, as in the reference), and mobility runs on the tensor
engine only (`from_config` with an armed model raises `ValueError`).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..api import engine as _engine
from ..api.front import batched_policies, solve, solve_many
from ..api.registry import get_solver
from ..core.instances import (PAPER_ACC, PAPER_COMM, PAPER_P_ED,
                              PAPER_P_ES_PROC)
from ..core.faults import FaultModel, FaultRealization
from ..core.hi import HILearnerState, HIModel
from ..core.lp import _check_backend
from ..core.mobility import MobilityModel
from ..core.problem import ES_DISABLED_SENTINEL, FleetProblem, Problem
from ..core.types import OffloadInstance, Schedule
from .profile import TierProfile, roofline_profile
from .queue import RequestQueue
from .runtime import audit_profile

class UnsolvedPeriodError(RuntimeError):
    """A delegated period left ``n_unsolved`` LP lanes uncertified under
    ``strict="raise"``.  Carries the failing ``period`` and
    ``partial_stats``, every `FleetPeriodStats` completed before it (the
    engine's ``history`` holds the same).  The period core has already
    replanned the unsolved lanes with the greedy local-only fill, so
    ``strict="warn"`` books the period and goes on."""

    def __init__(self, message: str, *, period: int, n_unsolved: int,
                 partial_stats: List["FleetPeriodStats"]):
        super().__init__(message)
        self.period = period
        self.n_unsolved = n_unsolved
        self.partial_stats = partial_stats


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


# an H100 SXM as the ES tier (NVIDIA data sheet: dense bf16 tensor rate,
# HBM3 bandwidth): the `make_fleet` / `FleetConfig` keywords of the port's
# examples and smokes
H100_ES = dict(es_peak_flops=989e12, es_hbm_bw=3.35e12)


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


def _ed_time_under(profile: TierProfile, job_classes: np.ndarray,
                   assignment: np.ndarray) -> float:
    """ED-tier time of a schedule priced with ``profile``'s latencies."""
    if len(job_classes) == 0:
        return 0.0
    ci = np.searchsorted(np.asarray(profile.classes), job_classes)
    mask = assignment < profile.p_ed.shape[1]
    if not mask.any():
        return 0.0
    return float(profile.p_ed[ci[mask], assignment[mask]].sum())


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
    # realized execution (chaos; see serving.faults): fault-free periods
    # report n_offload_ok == n_offload_samples, zero ladder counters, and
    # realized_makespan == the priced fleet makespan
    n_offload_samples: int = 0
    n_offload_ok: int = 0
    n_deadline_miss: int = 0
    n_retries: int = 0
    n_fallback_local: int = 0
    n_dropped: int = 0
    realized_makespan: float = 0.0
    n_es_audit_updates: int = 0
    # online hierarchical inference: every sample runs the local model, so
    # n_hi_offloaded + n_hi_local_final == n_jobs; zeros while HI is off
    n_hi_offloaded: int = 0
    n_hi_local_final: int = 0
    hi_regret: float = 0.0


# `FleetPeriodStats` fields a delegated period books straight from the
# period core's metrics
_V2_STATS = ("n_violations", "worst_violation", "n_offloading",
             "n_backpressured", "n_outage", "n_straggler_updates",
             "es_utilization", "n_offload_samples", "n_offload_ok",
             "n_deadline_miss", "n_retries", "n_fallback_local",
             "n_dropped", "realized_makespan", "n_es_audit_updates",
             "n_hi_offloaded", "n_hi_local_final", "hi_regret")


class EdgeServerPool:
    """``n_servers`` ES tiers, each offering T seconds per period.
    Admission is greedy — ascending demand (device id on ties),
    least-loaded server first — so every admitted server load respects
    the paper's constraint (2); it is not an optimal bin packing."""

    def __init__(self, n_servers: int):
        if n_servers <= 0:
            raise ValueError("n_servers must be positive")
        self.n_servers = n_servers

    def admit(self, demands: Dict[int, float], T: float):
        """``demands``: device id -> ES seconds.  Returns ``(admitted ids,
        per-server loads)``, visiting devices in (demand, id) order —
        never the dict's order — as `admit_mask` does."""
        loads = np.zeros(self.n_servers)
        admitted: List[int] = []
        for dev in sorted(demands, key=lambda d: (demands[d], d)):
            need = demands[dev]
            slot = int(np.argmin(loads))
            if loads[slot] + need <= T + 1e-12:
                loads[slot] += need
                admitted.append(dev)
        return admitted, loads

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


def _padded_instance(profile: TierProfile, job_classes: np.ndarray,
                     T: float, n_total: int, *,
                     disable_es: bool) -> OffloadInstance:
    """One device's instance padded with phantom jobs (p = 0: free
    everywhere, stripped later) to the planning window ``n_total``."""
    k = len(job_classes)
    if k > n_total:
        raise ValueError(f"{k} jobs exceed planning window {n_total}")
    m = profile.p_ed.shape[1]
    p_ed = np.zeros((n_total, m))
    p_es = np.zeros(n_total)
    if k:
        ci = np.searchsorted(np.asarray(profile.classes), job_classes)
        p_ed[:k] = profile.p_ed[ci]
        p_es[:k] = ES_DISABLED_SENTINEL if disable_es else profile.p_es[ci]
    return OffloadInstance(p_ed=p_ed, p_es=p_es, acc=profile.acc.copy(), T=T)


def _strip_phantoms(padded: Schedule, k: int) -> Schedule:
    """The schedule of the first ``k`` (real) jobs of a padded one."""
    inst = padded.instance
    real = OffloadInstance(p_ed=inst.p_ed[:k], p_es=inst.p_es[:k],
                           acc=inst.acc, T=inst.T)
    return Schedule(assignment=padded.assignment[:k].copy(), instance=real,
                    lp_accuracy=None, n_fractional=padded.n_fractional,
                    status=padded.status, solver=padded.solver)


@dataclasses.dataclass
class FleetConfig:
    """The whole engine in one value — policy, ES pool, traffic and fleet
    composition; `FleetEngine.from_config` is the one-call equivalent of
    `make_fleet` + `RequestQueue` + `FleetEngine`, and
    `api.engine.EngineParams.from_config` its tensor-engine twin.

    ``devices`` gives an explicit fleet; otherwise `make_fleet` draws one
    from ``seed`` and the fractions below, its ES tier at
    ``es_peak_flops`` / ``es_hbm_bw`` (required: the reference's defaults
    are TPU v5e figures).  ``backend`` is "torch" or "numpy"; the
    reference's "jax" is refused.  ``lp_method`` picks the delegated LP's
    pivot representation (the reference's engine fixes "tableau").
    ``faults`` arms chaos (delegation only); ``fault_trace`` (port-only)
    replays a fault realization per period instead of drawing.
    ``mobility`` arms mobility for `EngineParams.from_config` (the tensor
    engine only).  ``hi`` arms online hierarchical inference (delegation
    only; ``hi_rule`` picks the rule, the confidence gate replaces the
    plan)."""

    # engine
    n_devices: int
    T: float
    es_peak_flops: float
    es_hbm_bw: float
    n_servers: int = 1
    policy: str = "auto"
    backend: str = "torch"
    straggler_threshold: float = 1.5
    ema: float = 0.5
    # False forces the host period pipeline where delegation would apply
    delegate: bool = True
    lp_method: str = "tableau"
    # "raise": an unsolved delegated period raises UnsolvedPeriodError;
    # "warn": warn and book it
    strict: str = "raise"
    # chaos: fault injection and the degradation ladder (delegation
    # only; see serving.faults).  None / FaultModel.none() disarms.
    faults: Optional[FaultModel] = None
    max_retries: int = 2
    fault_seed: int = 0
    fault_trace: Optional[FaultRealization] = None
    # multi-cell mobility (the tensor engine only; see core.mobility).
    # None disarms; `EngineParams.from_config` picks these up.
    mobility: Optional[MobilityModel] = None
    mobility_mode: str = "replay"
    routing: str = "nearest"
    mobility_seed: int = 0
    # online hierarchical inference (delegation only; see serving.hi).
    # None disarms; `EngineParams.from_config` picks these up.
    hi: Optional[HIModel] = None
    hi_rule: str = "threshold"
    hi_stream: str = "fold"
    hi_arms: int = 9
    hi_seed: int = 0
    hi_local: int = 0
    # traffic (RequestQueue)
    classes: Sequence[int] = (128, 512, 1024)
    rate: float = 10.0
    batch_max: int = 12
    trace: Optional[np.ndarray] = None
    class_probs: Optional[Sequence[float]] = None
    # fleet composition (make_fleet); ignored when `devices` is given
    devices: Optional[Sequence[DeviceSpec]] = None
    roofline_frac: float = 0.5
    straggler_frac: float = 0.25
    outage_frac: float = 0.1
    drift_mag: float = 3.0
    horizon: int = 64
    seed: int = 0

    def build_devices(self) -> List[DeviceSpec]:
        if self.devices is not None:
            if len(self.devices) != self.n_devices:
                raise ValueError(
                    f"config names {self.n_devices} devices but "
                    f"{len(self.devices)} DeviceSpecs were given")
            return list(self.devices)
        return make_fleet(self.n_devices, es_peak_flops=self.es_peak_flops,
                          es_hbm_bw=self.es_hbm_bw, classes=self.classes,
                          roofline_frac=self.roofline_frac,
                          straggler_frac=self.straggler_frac,
                          outage_frac=self.outage_frac,
                          drift_mag=self.drift_mag, horizon=self.horizon,
                          seed=self.seed)

    def build_queue(self) -> RequestQueue:
        return RequestQueue(self.n_devices, self.classes, rate=self.rate,
                            batch_max=self.batch_max, seed=self.seed,
                            trace=self.trace, class_probs=self.class_probs)


class FleetEngine:
    """Drives the whole fleet, one period at a time; the LP, the DP and
    the delegated period core run on ``device`` (the CUDA card unless
    named)."""

    @classmethod
    def from_config(cls, config: FleetConfig, *,
                    device: DeviceLike = None) -> "FleetEngine":
        """The engine a `FleetConfig` describes (the same fleet, queue and
        policy as the manual construction)."""
        if config.mobility is not None and not getattr(
                config.mobility, "is_null", lambda: True)():
            # positions, cells and handover live in the tensor engine's
            # state; the host period pipeline has no twin of routing and
            # per-cell admission
            raise ValueError(
                "multi-cell mobility runs on the pure-functional engine "
                "only: build EngineParams.from_config(config) and use "
                "repro_torch.api.engine.rollout instead of FleetEngine")
        return cls(config.build_devices(), config.build_queue(),
                   n_servers=config.n_servers, T=config.T,
                   policy=config.policy, backend=config.backend,
                   straggler_threshold=config.straggler_threshold,
                   ema=config.ema, delegate=config.delegate,
                   lp_method=config.lp_method, strict=config.strict,
                   faults=config.faults, max_retries=config.max_retries,
                   fault_seed=config.fault_seed,
                   fault_trace=config.fault_trace, hi=config.hi,
                   hi_rule=config.hi_rule, hi_stream=config.hi_stream,
                   hi_arms=config.hi_arms, hi_seed=config.hi_seed,
                   hi_local=config.hi_local, device=device)

    def __init__(self, devices: Sequence[DeviceSpec], queue: RequestQueue, *,
                 n_servers: int = 1, T: float, policy: str = "auto",
                 backend: str = "torch", straggler_threshold: float = 1.5,
                 ema: float = 0.5, delegate: bool = True,
                 lp_method: str = "tableau", strict: str = "raise",
                 faults: Optional[FaultModel] = None, max_retries: int = 2,
                 fault_seed: int = 0,
                 fault_trace: Optional[FaultRealization] = None,
                 hi: Optional[HIModel] = None, hi_rule: str = "threshold",
                 hi_stream: str = "fold", hi_arms: int = 9,
                 hi_seed: int = 0, hi_local: int = 0,
                 device: DeviceLike = None):
        if queue.n_devices != len(devices):
            raise ValueError("queue.n_devices must match the fleet size")
        if strict not in ("raise", "warn"):
            raise ValueError(f"strict={strict!r}; expected 'raise' or "
                             f"'warn'")
        _check_backend(backend)
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
        self.devices = [_DeviceState(spec=d, profile=d.profile)
                        for d in devices]
        self.queue = queue
        self.pool = EdgeServerPool(n_servers)
        self.T = T
        self.policy = policy
        self.backend = backend
        # batched solves on the card; a solver without a batched path
        # (greedy), or the NumPy backend, plans device by device
        self._batched = backend == "torch" and policy in batched_policies()
        self.straggler_threshold = straggler_threshold
        self.ema = ema
        self.strict = strict
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
        self._dev_slot: Dict[int, tuple] = {}    # device -> (group, row)
        for g in self._groups:
            for row, d in enumerate(g.ids):
                self._dev_slot[int(d)] = (g, row)
        # delegation: the period core of the tensor engine, with the queue
        # and the stats on the host.  `_v2_params` is None (and the host
        # pipeline runs) unless delegate, the torch backend, amr2/dual
        # and one shape group all hold.
        self._v2_params = None
        if delegate and backend == "torch" \
                and policy in _engine.TRACEABLE_POLICIES \
                and len(self._groups) == 1:
            # arrivals come from the host queue: "poisson" only skips the
            # presampled trace
            self._v2_params = _engine.EngineParams.from_fleet(
                devices, queue, T=T, n_servers=n_servers, policy=policy,
                horizon=1, arrivals="poisson",
                straggler_threshold=straggler_threshold, ema=ema,
                lp_method=lp_method, faults=faults, max_retries=max_retries,
                fault_seed=fault_seed, fault_trace=fault_trace,
                device=self.device)
            g = self._groups[0]
            qcls = np.asarray(queue.classes)
            self._v2_lut = np.searchsorted(np.asarray(g.classes), qcls)
            # arrival value -> queue class index, right on an unsorted
            # queue class table too
            self._v2_qorder = np.argsort(qcls, kind="stable")
            self._v2_qsorted = qcls[self._v2_qorder]
            # the audited ES belief, threaded between periods as the
            # rollout's EngineState.p_es_belief (== p_es until chaos
            # inflates rows)
            self._v2_es_belief = self._v2_params.p_es.clone()
            self._v2_hi_state = None
            if hi is not None:
                # arm HI on the delegated params (chaos must be off) and
                # carry the learner between periods as the rollout's
                # EngineState.hi
                self._v2_params = self._v2_params.with_hi(
                    hi, rule=hi_rule, stream=hi_stream, n_arms=hi_arms,
                    hi_seed=hi_seed, local_model=hi_local)
                self._v2_hi_state = HILearnerState.init(
                    len(devices), hi_arms, self._v2_params.hi.theta0,
                    device=self.device)
        if faults is not None and not faults.is_null() \
                and self._v2_params is None:
            # the ladder lives in the tensor engine's period core; there
            # is no host twin of the realized-execution pass
            raise ValueError(
                "fault injection needs the engine-v2 delegation (torch "
                "backend, amr2/dual policy, one profile shape group, "
                "delegate=True); this engine would run the host period "
                "pipeline")
        if hi is not None and self._v2_params is None:
            # the confidence gate and the learner live in the tensor
            # engine's period core; the host pipeline has no twin
            raise ValueError(
                "online hierarchical inference needs the engine-v2 "
                "delegation (torch backend, amr2/dual policy, one profile "
                "shape group, delegate=True); this engine would run the "
                "host period pipeline")

    def run(self, periods: int) -> List[FleetPeriodStats]:
        """Run ``periods`` periods.  Under ``strict="raise"`` an unsolved
        delegated period raises `UnsolvedPeriodError`; the completed
        periods' stats are on the error and on ``history``."""
        return [self.run_period() for _ in range(periods)]

    def run_period(self) -> FleetPeriodStats:
        """One period: delegated to the tensor engine's period core when
        the fleet allows it, else the host pipeline."""
        if self._v2_params is not None:
            return self._run_period_v2()
        return self._run_period_host()

    def _run_period_v2(self) -> FleetPeriodStats:
        """The period through `api.engine._period` on ``device``: the host
        polls the queue, hands over padded class indices and counts, and
        books the stats; planning, admission, replans, pricing and the
        audit are the tensor engine's, so `run` equals `rollout` of the
        same config bit for bit."""
        t = self._period
        self._period += 1
        arrivals = self.queue.poll(t)
        D = len(self.devices)
        g = self._groups[0]
        params = self._v2_params
        n_pad = self.queue.batch_max
        take = np.fromiter((len(a) for a in arrivals), dtype=np.int32,
                           count=D)
        ci = np.zeros((D, n_pad), dtype=np.int32)
        for d, a in enumerate(arrivals):
            if len(a):
                ci[d, :len(a)] = self._v2_qorder[
                    np.searchsorted(self._v2_qsorted, a)]
        outage = np.fromiter((st.spec.outage_at(t) for st in self.devices),
                             dtype=bool, count=D)
        drift = np.fromiter((st.spec.drift_at(t) for st in self.devices),
                            dtype=np.float64, count=D)
        belief = np.ascontiguousarray(g.p_ed[:, self._v2_lut, :])
        warm = (np.asarray(g.warm_basis, np.int32)
                if g.warm_basis is not None
                else np.full((D, params.n_basis_rows), -1, np.int32))
        if t > 0:
            # the ES column set changed (outage flip): that lane's basis
            # labels another LP, so it starts cold
            prev = np.fromiter(
                (st.spec.outage_at(t - 1) for st in self.devices),
                dtype=bool, count=D)
            warm = np.where((prev != outage)[:, None], np.int32(-1), warm)

        dev = self.device
        t0 = time.perf_counter()
        # the period's fault realization: the draw (or replayed entry)
        # `rollout` makes for period t
        real = _engine._realization(params, t) if params.chaos else None
        # HI: the period's draws and the learner, as `rollout` threads them
        hi_draws = _engine._hi_draws(params, t) if params.hi_armed else None
        _belief, new_warm, upd, factor, es_belief, _load, new_hi, m = \
            _engine._period(
                torch.as_tensor(belief, device=dev),
                torch.as_tensor(warm, device=dev),
                torch.as_tensor(ci, device=dev),
                torch.as_tensor(take, device=dev),
                torch.as_tensor(drift, device=dev),
                torch.as_tensor(outage, device=dev), self._v2_es_belief,
                params, real=real, hi_state=self._v2_hi_state, hi_t=t,
                hi_draws=hi_draws)
        self._v2_es_belief = es_belief
        self._v2_hi_state = new_hi
        m = {k: v.item() for k, v in m.items()}
        plan_seconds = time.perf_counter() - t0
        if m["n_unsolved"]:
            # never serve an uncertified plan silently; the core already
            # replanned those lanes with the greedy local-only fill
            msg = (f"period {t}: {m['n_unsolved']} device plan(s) were "
                   f"not solved to optimality (simplex iteration limit or "
                   f"unbounded LP); raise maxiter — the lanes were served "
                   f"by the greedy local-only fallback")
            if self.strict == "warn":
                warnings.warn(msg, RuntimeWarning, stacklevel=3)
            else:
                raise UnsolvedPeriodError(
                    msg, period=t, n_unsolved=m["n_unsolved"],
                    partial_stats=list(self.history))

        if self.policy == "amr2":       # only the LP carries its bases
            g.warm_basis = new_warm.cpu().numpy().astype(np.int64)
        upd = upd.cpu().numpy()
        if upd.any():
            factor = factor.cpu().numpy()
            g.p_ed[upd] *= factor[upd, None, None]
            for r in np.nonzero(upd)[0]:
                st = self.devices[int(g.ids[r])]
                st.profile = dataclasses.replace(
                    st.profile, p_ed=g.p_ed[r].copy())
                st.n_updates += 1

        n_jobs = m["n_jobs"]
        total_acc = m["total_accuracy"]
        stats = FleetPeriodStats(
            period=t, n_devices=D, n_jobs=n_jobs,
            plan_seconds=plan_seconds, total_accuracy=total_acc,
            mean_job_accuracy=total_acc / n_jobs if n_jobs else 0.0,
            backlog=self.queue.backlog,
            **{f: m[f] for f in _V2_STATS})
        self.history.append(stats)
        self.solver_log.append({
            "plan": Counter({self.policy: D}),
            "replan": Counter({self.policy: m["n_backpressured"]})})
        return stats

    def _run_period_host(self) -> FleetPeriodStats:
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
            if self.backend == "torch" and g.warm_basis is not None:
                wb = np.asarray(g.warm_basis)
                if stale_all is not None:
                    wb = np.where(stale_all[g.ids][:, None], -1, wb)
                warm["warm_start"] = wb
            sol = solve(fp, policy=self.policy, backend=self.backend,
                        device=self.device, **warm)
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
                                backend=self.backend, es_disabled=True,
                                device=self.device)
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

    def run_period_reference(self) -> FleetPeriodStats:
        """The reference's per-device period loop: padding and stripping
        per device, sequential backpressure replans, the per-device audit
        (`audit_profile`).  Every solve runs on this engine's backend; it
        is the oracle the array-resident loop is held to and the baseline
        a bench measures it against."""
        t = self._period
        self._period += 1
        arrivals = self.queue.poll(t)
        n_pad = self.queue.batch_max
        outages = [st.spec.outage_at(t) for st in self.devices]

        padded = [_padded_instance(st.profile, arrivals[d], self.T, n_pad,
                                   disable_es=outages[d])
                  for d, st in enumerate(self.devices)]
        sols = solve_many([Problem.from_instance(p) for p in padded],
                          policy=self.policy, backend=self.backend,
                          device=self.device)
        plan_seconds = sum(s.plan_seconds for s in sols)
        scheds = [_strip_phantoms(s.to_schedule(), len(arrivals[d]))
                  for d, s in enumerate(sols)]

        # --- ES capacity: admit offload demand server by server ----------
        demands = {d: s.es_makespan for d, s in enumerate(scheds)
                   if s.es_makespan > 0}
        admitted, loads = self.pool.admit(demands, self.T)
        bumped = sorted(set(demands) - set(admitted))
        for d in bumped:  # backpressure: replan ED-only, one at a time
            fb = solve(Problem.from_instance(scheds[d].instance),
                       policy=self.policy, backend=self.backend,
                       es_disabled=True, device=self.device)
            scheds[d] = fb.to_schedule()
            plan_seconds += fb.plan_seconds

        # --- execution and the straggler audit ----------------------------
        n_jobs = 0
        total_acc = 0.0
        worst_viol = 0.0
        n_viol = 0
        n_updates = 0
        n_off_samples = 0
        realized_makespan = 0.0
        for d, st in enumerate(self.devices):
            sched = scheds[d]
            n_jobs += sched.instance.n
            total_acc += sched.total_accuracy
            n_off_samples += int(
                (sched.assignment == sched.instance.p_ed.shape[1]).sum())
            ed_wall = _ed_time_under(st.spec.profile, arrivals[d],
                                     sched.assignment) * st.spec.drift_at(t)
            es_wall = 0.0 if d in bumped else sched.es_makespan
            wall = max(ed_wall, es_wall)
            realized_makespan = max(realized_makespan, wall)
            viol = max(0.0, wall / self.T - 1.0)
            worst_viol = max(worst_viol, viol)
            n_viol += viol > 0
            new_profile, updated = audit_profile(
                st.profile, sched.ed_makespan, ed_wall,
                threshold=self.straggler_threshold, ema=self.ema)
            if updated:
                st.profile = new_profile
                st.n_updates += 1
                n_updates += 1
                g, row = self._dev_slot[d]      # keep the stacks in sync
                g.p_ed[row] = new_profile.p_ed

        stats = FleetPeriodStats(
            period=t, n_devices=len(self.devices), n_jobs=n_jobs,
            plan_seconds=plan_seconds, total_accuracy=total_acc,
            mean_job_accuracy=total_acc / n_jobs if n_jobs else 0.0,
            n_violations=n_viol, worst_violation=worst_viol,
            n_offloading=len(demands), n_backpressured=len(bumped),
            n_outage=int(sum(outages)), n_straggler_updates=n_updates,
            es_utilization=float(loads.sum()) / (self.pool.n_servers
                                                 * self.T),
            backlog=self.queue.backlog,
            n_offload_samples=n_off_samples, n_offload_ok=n_off_samples,
            realized_makespan=realized_makespan)
        self.history.append(stats)
        return stats

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
