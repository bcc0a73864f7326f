"""Fleet engine: `EngineParams`, `EngineState`, `step` and `rollout`.

Port of `repro.api.engine` — ``policy="amr2"`` or ``"dual"``, replayed or
Poisson arrivals, the chaos, mobility and online hierarchical inference
(HI) scenarios, and the differentiable rollout.  Each period:

  * moves and routes the devices when mobility is armed (replayed
    positions or a random walk; `mobility.route_cells`), and cold-starts
    and re-prices a device that changed cells (handover);
  * releases this period's arrivals (`_arrivals`): from the replayed
    trace, or drawn on the params' device (``arrivals="poisson"``);
  * assembles the padded `FleetProblem` (outage and uncovered devices
    price the ES at the disabled sentinel; a lane whose outage flag
    flipped starts cold; a routed device's ES times scale by its link
    factor; the ES column is priced from the audited ES belief);
  * plans every device in one batched solve (`_plan`): under amr2
    `amr2.build_lp_arrays_torch` -> `lp.simplex_batch_core` (warm from last
    period's basis) -> `amr2.round_relaxation_torch`; under dual the
    bisection `dual.dual_one_batch`, which carries no basis.  Under HI the
    confidence gate replaces the plan (`hi.sample_confidence`,
    `hi.hi_period`): every sample runs the local model ``hi_local``, and
    the gate offloads the low-confidence ones;
  * recovers lanes whose LP did not finish with the greedy local fill
    (`_recover_unsolved`);
  * admits offloads to the ES pool (`mobility.admit_mask_pool`; per cell
    with `mobility.admit_mask_segmented` when there are several);
  * replans the devices admission bumped, ES disabled, in a lane-masked
    cold solve (under HI a bumped device's samples stay local);
  * prices the plan; under chaos, replays it through the period's fault
    realization and walks the degradation ladder
    (`faults.realize_execution`), and EMA-inflates the ES belief of
    devices whose realized ES time blew past the priced one;
  * runs the EMA straggler audit and emits `PeriodMetrics`.

The reference scans a jitted step with ``lax.scan``; here `rollout` is a
Python loop over `step`, and the simplex phases inside read their loop
condition on the host.  Everything is float64 (`_require_f64`): a float32
simplex cycles until ``maxiter``.

The differentiable rollout (`EngineParams.with_differentiable`,
`rollout_value_and_grad`) runs the same periods under autograd: the LP
through `lp.simplex_batch_grad` (the pivot kernels forward, the implicit
KKT adjoint backward), Algorithm 2's rounding and the first-fit admission
relaxed (``smooth_mode`` "st": the hard forward with the relaxed
Jacobians; "soft": the relaxed forward), the value the epoch's summed
``total_accuracy``.

Random streams cannot redraw jax's threefry streams.  Poisson arrivals,
faults, the mobility walk and HI's confidences and EXP3 arm draws are
drawn on the params' device from generators seeded by (seed, period)
(`_device.seeded_generator`), for the whole fleet at once, so a device's
draw depends only on the seed, the period and its index in the fleet;
they match the reference in distribution, not draw for draw.  Parity runs
replay: arrivals from the presampled trace, positions from
``mobility.trace``, confidences from ``hi.conf_trace`` (``hi_stream=
"replay"``), and two port-only fields — ``fault_trace`` (a realization
per period) and ``hi_arm_trace`` (EXP3's arm uniforms, (H, D)); period t
reads entry t mod H, and the draw fills in when a trace is None.

Sharding (`fleet_mesh`, `shard`, `step_sharded`, `rollout_sharded`) splits
the fleet axis over the ranks of a `torch.distributed` group, one process
per shard (`_mesh`): each rank runs the same periods on its block of
devices; admission gathers the ES demand of the whole fleet (or, under
``shard_by_cell``, all-reduces the per-cell loads), and each period's
metrics are reduced in three packed collectives, so every rank returns
the unsharded run's metrics.  A shard's draws are the whole fleet's draws
for its (seed, period), of which it keeps its rows.

Entry points run on the CUDA card unless given ``device="cpu"``; with no
card and no device they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import (DeviceLike, check_device, resolve_device,
                       seeded_generator as _generator)
from .._mesh import FleetAxis, fleet_mesh
from ..core.amr2 import (build_lp_arrays_torch, round_relaxation_torch,
                         soft_assignment_weights, straight_through_weights)
from ..core.dual import dual_one_batch
from ..core.faults import (FaultModel, FaultRealization, greedy_local_fill,
                           realize_execution, sample_realization)
from ..core.hi import (HI_STATE_FIELDS, HILearnerState, HIModel,
                       draw_arm_uniforms,
                       draw_uniforms, hi_period, sample_confidence,
                       validate_hi)
from ..core.lp import _bucket_maxiter, simplex_batch_core, simplex_batch_grad
from ..core.mobility import (MobilityModel, admit_mask_pool,
                             admit_mask_segmented, route_cells,
                             validate_mobility)
from ..core.problem import (ES_DISABLED_SENTINEL, ST_UNSOLVED, FleetProblem,
                            slot_sum as _slot_sum)

TRACEABLE_POLICIES = ("amr2", "dual")

# EngineParams tensors `rollout_grad` may differentiate: the continuous
# fleet knobs
GRAD_LEAVES = ("p_es", "base_p_ed", "acc", "T")


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
    not carried.

    Scenarios: ``faults`` is read only while ``chaos`` is set
    (`with_faults`), ``mobility`` (float64 tensors on the params' device)
    only while ``mobility_mode`` is not "off" (`with_mobility`), ``hi``
    only while ``hi_rule`` is not "off" (`with_hi`).  Two fields are
    port-only replays of a draw: ``fault_trace``, a `FaultRealization`
    with a leading period axis on every field, and ``hi_arm_trace``, (H,
    D) EXP3 arm uniforms (period t reads entry t mod H; parity runs fill
    them with the reference's draws).  ``differentiable`` arms the
    relaxed rollout (`with_differentiable`)."""

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
    faults: FaultModel = dataclasses.field(default_factory=FaultModel.none)
    mobility: MobilityModel = dataclasses.field(
        default_factory=MobilityModel.none)
    fault_trace: Optional[FaultRealization] = None
    hi: HIModel = dataclasses.field(default_factory=HIModel.none)
    hi_arm_trace: Optional[torch.Tensor] = None
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
    # chaos: ``chaos`` arms the realized-execution pass, ``max_retries``
    # bounds the ladder's unrolled retry rounds, ``fault_seed`` seeds the
    # fault draws (independent of the arrivals)
    chaos: bool = False
    max_retries: int = 2
    fault_seed: int = 0
    # mobility: "off", "replay" (``mobility.trace``) or "walk" (steps from
    # ``mobility_seed``); ``n_cells`` splits the ``n_servers`` pool evenly;
    # ``routing`` "nearest" or "min_time"; ``shard_by_cell`` lets each
    # shard of a sharded rollout admit its own devices and merge only the
    # per-cell loads (valid when a shard's devices roam only its cells)
    mobility_mode: str = "off"
    routing: str = "nearest"
    n_cells: int = 1
    mobility_seed: int = 0
    shard_by_cell: bool = False
    # HI: ``hi_rule`` "off" or one of `hi.HI_RULES`; ``hi_stream`` "fold"
    # (drawn from ``hi_seed``) or "replay" (``hi.conf_trace``);
    # ``hi_arms`` sizes the bandits' grid; ``hi_local`` is the local model
    # every sample runs on
    hi_rule: str = "off"
    hi_stream: str = "fold"
    hi_arms: int = 9
    hi_seed: int = 0
    hi_local: int = 0
    # the differentiable rollout: ``smooth_mode`` "st" (hard forward,
    # relaxed Jacobians) or "soft" (relaxed forward); ``smooth_tau``
    # tempers the assignment softmax, ``admit_tau`` the sigmoid capacity
    # test (in units of T); ``grad_leaves`` the default leaves of
    # `rollout_grad`
    differentiable: bool = False
    smooth_mode: str = "st"
    smooth_tau: float = 0.25
    admit_tau: float = 0.05
    grad_leaves: Tuple[str, ...] = ("p_es", "T", "acc")

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

    @property
    def servers_per_cell(self) -> int:
        """ES servers fronted by each cell (the whole pool when S = 1)."""
        return self.n_servers // max(self.n_cells, 1)

    @property
    def m(self) -> int:
        """Local models per device."""
        return self.base_p_ed.shape[2]

    @property
    def hi_armed(self) -> bool:
        """Online hierarchical inference replaces the plan."""
        return self.hi_rule != "off"

    @classmethod
    def from_fleet(cls, devices, queue, *, T: float, n_servers: int = 1,
                   policy: str = "amr2", horizon: int = 64,
                   arrivals: str = "replay",
                   straggler_threshold: float = 1.5, ema: float = 0.5,
                   frac_tol: float = 1e-4, iters: int = 40,
                   maxiter: Optional[int] = None, tol: float = 1e-7,
                   lp_method: str = "tableau",
                   faults: Optional[FaultModel] = None,
                   max_retries: int = 2, fault_seed: int = 0,
                   fault_trace: Optional[FaultRealization] = None,
                   mobility: Optional[MobilityModel] = None,
                   mobility_mode: str = "replay", routing: str = "nearest",
                   mobility_seed: int = 0,
                   device: DeviceLike = None) -> "EngineParams":
        """Build params from `DeviceSpec`s and a `RequestQueue` (one shape
        group: every profile shares a class table and model count).
        ``device`` defaults to the CUDA card.  Only the replay mode
        presamples the queue's trace (``horizon`` periods).  A non-null
        ``faults`` arms chaos; a ``mobility`` model arms mobility in
        ``mobility_mode``; ``fault_trace`` (port-only) replays faults."""
        dev = resolve_device(device)
        if policy == "auto":
            policy = "amr2"
        _validate_config(policy=policy, arrivals=arrivals,
                         lp_method=lp_method)
        if horizon <= 0:
            raise ValueError("horizon must be positive")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if queue.n_devices != len(devices):
            raise ValueError("queue.n_devices must match the fleet size")
        mob = mobility if mobility is not None else MobilityModel.none()
        mob_mode = mobility_mode if mobility is not None else "off"
        validate_mobility(mob, n_devices=len(devices), n_servers=n_servers,
                          mode=mob_mode, routing=routing)
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
        fm = faults if faults is not None else FaultModel.none()
        return params_from_arrays(
            arrays, dev, policy=policy, arrivals=arrivals,
            n_servers=n_servers, batch_max=queue.batch_max,
            straggler_threshold=straggler_threshold, ema=ema,
            frac_tol=frac_tol, iters=iters, maxiter=maxiter, tol=tol,
            lp_method=lp_method, faults=fm, chaos=not fm.is_null(),
            max_retries=max_retries, fault_seed=fault_seed,
            fault_trace=fault_trace, mobility=mob, mobility_mode=mob_mode,
            routing=routing, n_cells=mob.n_cells if mob_mode != "off" else 1,
            mobility_seed=mobility_seed)

    @classmethod
    def from_config(cls, config, *, horizon: Optional[int] = None,
                    arrivals: str = "replay", policy: Optional[str] = None,
                    lp_method: Optional[str] = None,
                    device: DeviceLike = None) -> "EngineParams":
        """Build params from a `serving.FleetConfig` (the engine's twin of
        `FleetEngine.from_config`).  The replayed trace covers ``horizon``
        periods (default: the config's ``horizon``); ``lp_method``
        defaults to the config's.  The config's chaos, mobility and HI
        fields arm those scenarios."""
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
            max_retries=getattr(config, "max_retries", 2),
            fault_seed=getattr(config, "fault_seed", 0),
            fault_trace=getattr(config, "fault_trace", None),
            mobility=getattr(config, "mobility", None),
            mobility_mode=getattr(config, "mobility_mode", "replay"),
            routing=getattr(config, "routing", "nearest"),
            mobility_seed=getattr(config, "mobility_seed", 0),
            device=device).with_hi(
                getattr(config, "hi", None),
                rule=getattr(config, "hi_rule", "threshold"),
                stream=getattr(config, "hi_stream", "fold"),
                n_arms=getattr(config, "hi_arms", 9),
                hi_seed=getattr(config, "hi_seed", 0),
                local_model=getattr(config, "hi_local", 0))

    def with_faults(self, faults: Optional[FaultModel], *,
                    max_retries: Optional[int] = None,
                    fault_seed: Optional[int] = None,
                    fault_trace: Optional[FaultRealization] = None
                    ) -> "EngineParams":
        """Arm (or disarm, with ``None`` / `FaultModel.none()`) chaos,
        keeping the ``chaos`` flag consistent with the model's nullness.
        ``fault_trace`` (port-only) replays those realizations instead of
        drawing; ``None`` draws."""
        fm = faults if faults is not None else FaultModel.none()
        if self.hi_armed and not fm.is_null():
            raise ValueError(
                "chaos needs HI disarmed (hi_rule='off'): the realized-"
                "execution ladder re-decides admitted samples and would "
                "corrupt the learner's feedback; disarm with "
                "with_hi(None) first")
        retries = self.max_retries if max_retries is None else max_retries
        if retries < 0:
            raise ValueError("max_retries must be >= 0")
        return dataclasses.replace(
            self, faults=fm, chaos=not fm.is_null(), max_retries=retries,
            fault_seed=(self.fault_seed if fault_seed is None
                        else fault_seed),
            fault_trace=_fault_trace_on(fault_trace, self.device,
                                        self.n_devices, self.batch_max,
                                        retries + 1))

    def with_mobility(self, mobility: Optional[MobilityModel], *,
                      mode: str = "replay", routing: str = "nearest",
                      mobility_seed: Optional[int] = None,
                      shard_by_cell: bool = False) -> "EngineParams":
        """Arm (or disarm, with ``None``) mobility.  Validates the geometry
        (`mobility.validate_mobility`) and keeps ``mobility_mode`` and
        ``n_cells`` consistent with the model.  ``shard_by_cell`` is read
        by the sharded entry points only: each shard admits its own
        devices per cell and the shards sum the per-cell loads, which
        equals the global admission when each shard's devices route only
        to its own cells."""
        mob = mobility if mobility is not None else MobilityModel.none()
        mob_mode = mode if mobility is not None else "off"
        if self.hi_armed and mob_mode != "off":
            raise ValueError(
                "mobility needs HI disarmed (hi_rule='off'): per-cell "
                "admission of confidence-gated offloads is a later rung; "
                "disarm with with_hi(None) first")
        validate_mobility(mob, n_devices=self.n_devices,
                          n_servers=self.n_servers, mode=mob_mode,
                          routing=routing)
        return dataclasses.replace(
            self, mobility=mob.to(self.device), mobility_mode=mob_mode,
            routing=routing,
            n_cells=mob.n_cells if mob_mode != "off" else 1,
            mobility_seed=(self.mobility_seed if mobility_seed is None
                           else mobility_seed),
            shard_by_cell=shard_by_cell)

    def with_differentiable(self, enabled: bool = True, *,
                            smooth_mode: str = "st",
                            smooth_tau: float = 0.25,
                            admit_tau: float = 0.05,
                            grad_leaves: Optional[Sequence[str]] = None
                            ) -> "EngineParams":
        """Arm (or disarm) the differentiable rollout.  It needs the amr2
        LP (the implicit gradient lives at the simplex's converged basis)
        and a deterministic accuracy pipeline, so chaos, mobility and HI
        must be disarmed; ``smooth_mode``, ``smooth_tau`` and
        ``admit_tau`` pick the relaxation (class docstring)."""
        if enabled:
            if self.policy != "amr2":
                raise ValueError(
                    f"differentiable rollouts need policy='amr2' (the LP "
                    f"relaxation carries the gradient); got "
                    f"{self.policy!r}")
            if self.chaos:
                raise ValueError(
                    "differentiable rollouts need chaos disarmed: the "
                    "fault ladder's retry/drop counters are discrete and "
                    "the realized-execution pass is not relaxed")
            if self.mobility_mode != "off":
                raise ValueError(
                    "differentiable rollouts need mobility off: routing "
                    "and the per-cell admission are not relaxed yet")
            if self.hi_armed:
                raise ValueError(
                    "differentiable rollouts need HI disarmed "
                    "(hi_rule='off'): the per-sample threshold gate and "
                    "the learner's argmax/draw updates are discrete and "
                    "not relaxed; disarm with with_hi(None) first")
            if smooth_mode not in ("st", "soft"):
                raise ValueError(f"unknown smooth_mode {smooth_mode!r}; "
                                 f"expected 'st' or 'soft'")
            if not (smooth_tau > 0 and admit_tau > 0):
                raise ValueError("smooth_tau and admit_tau must be > 0")
            gl = (tuple(grad_leaves) if grad_leaves is not None
                  else self.grad_leaves)
            _check_grad_leaves("grad_leaves", gl)
        else:
            gl = self.grad_leaves
        return dataclasses.replace(
            self, differentiable=enabled, smooth_mode=smooth_mode,
            smooth_tau=smooth_tau, admit_tau=admit_tau, grad_leaves=gl)

    def with_hi(self, hi: Optional[HIModel], *, rule: str = "threshold",
                stream: str = "fold", n_arms: int = 9,
                hi_seed: Optional[int] = None, local_model: int = 0,
                hi_arm_trace=None) -> "EngineParams":
        """Arm (or disarm, with ``None``) online hierarchical inference.
        Armed, the confidence gate replaces the plan: every sample runs
        ``local_model`` on the device and is also offloaded iff its
        confidence falls below the rule's threshold (`core.hi`); the
        learner's state is `EngineState.hi`.  HI composes with drift,
        outage and the ES-pool admission, not with chaos, mobility or the
        differentiable relaxation.  ``hi_arm_trace`` (port-only; (H, D))
        replays EXP3's arm uniforms; ``None`` draws them."""
        if hi is None:
            return dataclasses.replace(
                self, hi=HIModel.none().to(self.device), hi_rule="off",
                hi_stream="fold", hi_arm_trace=None)
        if self.chaos:
            raise ValueError(
                "HI needs chaos disarmed: the realized-execution ladder "
                "re-decides admitted samples and would corrupt the "
                "learner's feedback; disarm with with_faults(None) first")
        if self.mobility_mode != "off":
            raise ValueError(
                "HI needs mobility off: per-cell admission of confidence-"
                "gated offloads is a later rung; disarm with "
                "with_mobility(None) first")
        if self.differentiable:
            raise ValueError(
                "HI needs the differentiable relaxation disarmed: the "
                "threshold gate and learner updates are discrete; disarm "
                "with with_differentiable(False) first")
        validate_hi(hi, n_devices=self.n_devices,
                    n_classes=self.base_p_ed.shape[1], n_models=self.m,
                    rule=rule, stream=stream, n_arms=n_arms,
                    local_model=local_model, batch_max=self.batch_max)
        return dataclasses.replace(
            self, hi=hi.to(self.device), hi_rule=rule, hi_stream=stream,
            hi_arms=n_arms,
            hi_seed=self.hi_seed if hi_seed is None else hi_seed,
            hi_local=local_model,
            hi_arm_trace=_arm_trace_on(hi_arm_trace, self.device,
                                       self.n_devices))

    def to(self, device: DeviceLike) -> "EngineParams":
        """These params with every tensor on ``device``."""
        dev = torch.device(device)
        trace, arms = self.fault_trace, self.hi_arm_trace
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in PARAM_ARRAYS},
            mobility=self.mobility.to(dev), hi=self.hi.to(dev),
            fault_trace=(None if trace is None else FaultRealization(
                *(x.to(dev) for x in trace))),
            hi_arm_trace=None if arms is None else arms.to(dev))


# dtypes of the EngineParams tensors; everything else is float64
_PARAM_DTYPES = {"outage": torch.bool, "counts": torch.int32,
                 "stream": torch.int32}
PARAM_ARRAYS = tuple(f.name for f in dataclasses.fields(EngineParams)
                     if f.type == "torch.Tensor")
# the scenario models and replayed draws: objects of their own, carried by
# `params_from_arrays`
PARAM_SCENARIOS = ("faults", "mobility", "fault_trace", "hi",
                   "hi_arm_trace")
PARAM_CONFIG = tuple(f.name for f in dataclasses.fields(EngineParams)
                     if f.type != "torch.Tensor"
                     and f.name not in PARAM_SCENARIOS)


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


def _check_grad_leaves(what: str, leaves: Sequence[str]) -> None:
    bad = [f for f in leaves if f not in GRAD_LEAVES]
    if bad:
        raise ValueError(f"{what} {bad} not differentiable; the continuous "
                         f"EngineParams knobs are {GRAD_LEAVES}")


def _arm_trace_on(trace, device: torch.device,
                  n_devices: int) -> Optional[torch.Tensor]:
    """A replayed EXP3 arm-uniform trace (H, D) as float64 on ``device``."""
    if trace is None:
        return None
    t = torch.as_tensor(trace if isinstance(trace, torch.Tensor)
                        else np.asarray(trace), dtype=torch.float64,
                        device=device)
    if t.dim() != 2 or t.shape[1] != n_devices or t.shape[0] == 0:
        raise ValueError(f"hi_arm_trace must be (periods, {n_devices}) "
                         f"uniforms; got {tuple(t.shape)}")
    return t


def _fault_trace_on(trace, device: torch.device, n_devices: int,
                    n_jobs: int, n_attempts: int
                    ) -> Optional[FaultRealization]:
    """A replayed fault trace (fields of arrays or tensors with a leading
    period axis) as tensors on ``device``, its shapes checked against the
    fleet (``n_attempts`` = max_retries + 1)."""
    if trace is None:
        return None
    es_crash, link, strag, lost = (torch.as_tensor(
        np.asarray(x) if not isinstance(x, torch.Tensor) else x,
        device=device) for x in trace)
    H = es_crash.shape[0] if es_crash.dim() else 0
    want = {"es_crash": (H,), "link_factor": (H, n_devices),
            "straggler_factor": (H, n_devices),
            "lost": (H, n_devices, n_jobs, n_attempts)}
    got = dict(zip(want, (es_crash, link, strag, lost)))
    for name, shape in want.items():
        if H == 0 or tuple(got[name].shape) != shape:
            raise ValueError(
                f"fault_trace.{name} must be {shape} (periods, devices, "
                f"jobs, max_retries + 1); got {tuple(got[name].shape)}")
    return FaultRealization(es_crash=es_crash.to(torch.bool),
                            link_factor=link.to(torch.float64),
                            straggler_factor=strag.to(torch.float64),
                            lost=lost.to(torch.bool))


def params_from_arrays(arrays: Dict[str, object], device: torch.device, *,
                       faults: Optional[FaultModel] = None,
                       mobility: Optional[MobilityModel] = None,
                       fault_trace=None, hi: Optional[HIModel] = None,
                       hi_arm_trace=None, **config) -> EngineParams:
    """`EngineParams` from NumPy arrays/scalars named like its tensor
    fields (`PARAM_ARRAYS`), config keywords (`PARAM_CONFIG`, the
    ``chaos``, ``mobility_mode``, ``hi_rule`` and ``differentiable``
    flags taken as given) and the scenario models, carried to
    ``device``."""
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
    D = tensors["base_p_ed"].shape[0]
    trace = _fault_trace_on(fault_trace, device, D,
                            config.get("batch_max", 12),
                            config.get("max_retries", 2) + 1)
    mob = mobility if mobility is not None else MobilityModel.none()
    return EngineParams(**tensors, faults=faults if faults is not None
                        else FaultModel.none(),
                        mobility=mob.to(device), fault_trace=trace,
                        hi=(hi if hi is not None else HIModel.none()
                            ).to(device),
                        hi_arm_trace=_arm_trace_on(hi_arm_trace, device, D),
                        **config)


@dataclasses.dataclass(frozen=True)
class EngineState:
    """Everything a period mutates, as tensors on the params' device.

    ``seed`` takes the place of the reference's PRNG key: Poisson
    arrivals draw each period from generators seeded by (seed, period).
    ``hi`` is the HI learner's state (`init_state` always fills it; it is
    read and advanced only while HI is armed)."""

    period: torch.Tensor       # () int32
    p_ed: torch.Tensor         # (D, c, m) belief latencies (audit state)
    pending: torch.Tensor      # (D,) int32 backlog counts
    head: torch.Tensor         # (D,) int32 replay-stream cursors
    warm_basis: torch.Tensor   # (D, R) int32 previous optimal bases (-1 cold)
    n_updates: torch.Tensor    # (D,) int32 straggler-audit update counts
    pos: torch.Tensor          # (D, 2) device positions (mobility)
    cell: torch.Tensor         # (D,) int32 serving cell (-1: uncovered)
    cell_load: torch.Tensor    # (S,) last period's admitted load per cell
    p_es_belief: torch.Tensor  # (D, c) priced ES latencies (chaos audit)
    seed: torch.Tensor         # () int64 Poisson arrival seed
    hi: Optional[HILearnerState] = None


# the tensor fields (``hi`` is a learner state of its own)
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(EngineState)
                     if f.type == "torch.Tensor")
_STATE_DTYPES = {"period": torch.int32, "pending": torch.int32,
                 "head": torch.int32, "warm_basis": torch.int32,
                 "n_updates": torch.int32, "cell": torch.int32,
                 "seed": torch.int64}


def state_from_arrays(arrays: Dict[str, object],
                      device: torch.device) -> EngineState:
    """`EngineState` from NumPy arrays named like its tensor fields, and
    an optional ``hi`` (`HILearnerState`)."""
    missing = set(STATE_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing state arrays {sorted(missing)}")
    hi = arrays.get("hi")
    return EngineState(**{
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=_STATE_DTYPES.get(name, torch.float64),
                           device=device)
        for name in STATE_FIELDS}, hi=None if hi is None else hi.to(device))


@dataclasses.dataclass(frozen=True)
class PeriodMetrics:
    """One period's fleet-level numbers (0-d tensors; `rollout` stacks them
    into (periods,) tensors).  Every field of the reference is kept.
    With chaos off the ladder counters are 0, ``n_offload_ok ==
    n_offload_samples`` and ``realized_makespan`` is the priced makespan;
    under chaos ``n_offload_samples == n_offload_ok + n_fallback_local +
    n_dropped`` every period.  ``n_handover`` counts the devices that
    changed cells.  Under HI ``n_hi_offloaded + n_hi_local_final ==
    n_jobs`` every period and ``hi_regret`` is the fleet's cumulative
    pseudo-regret; all three are 0 while HI is off."""

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
    """A fresh fleet: beliefs = profiles, empty backlog, cold bases; with
    mobility armed, the trace's first positions and no serving cell yet;
    a fresh HI learner at ``hi.theta0``.  ``seed`` (>= 0) seeds Poisson
    arrivals and is unused by replay."""
    if seed < 0:
        raise ValueError("seed must be >= 0")
    dev = _entry_device(params, None, device)
    D = params.n_devices
    i32 = dict(dtype=torch.int32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    armed = params.mobility_mode != "off"
    return EngineState(
        period=torch.zeros((), **i32),
        p_ed=params.base_p_ed.clone(),
        pending=torch.zeros(D, **i32),
        head=torch.zeros(D, **i32),
        warm_basis=torch.full((D, params.n_basis_rows), -1, **i32),
        n_updates=torch.zeros(D, **i32),
        pos=(params.mobility.trace[0].clone() if armed
             else torch.zeros((D, 2), **f64)),
        cell=torch.full((D,), -1 if armed else 0, **i32),
        cell_load=torch.zeros(max(params.n_cells, 1), **f64),
        p_es_belief=params.p_es.clone(),
        seed=torch.tensor(seed, dtype=torch.int64, device=dev),
        hi=HILearnerState.init(D, params.hi_arms, params.hi.theta0,
                               device=dev))


# --------------------------------------------------------------------------
# period building blocks
# --------------------------------------------------------------------------
def _plan(params: EngineParams, fp: FleetProblem, warm_basis,
          lane_mask=None):
    """One batched solve of a padded `FleetProblem`.  amr2: the LP
    relaxation (warm-or-cold simplex) and its rounding; dual: the
    bisection over every lane (``lane_mask`` unused), no basis, status 0
    ok and 1 fallback.  Returns ``(assignment (D, n) int32, status (D,)
    int32, basis (D, R) int32, xbar)``; under dual the basis is
    ``warm_basis`` or, without one, all -1.  ``xbar`` is None unless
    ``differentiable`` is armed (amr2 only): then the LP goes through
    `lp.simplex_batch_grad` and ``xbar`` is its relaxation (D, n, m+1).  (The reference's CPU lane chunking,
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
        return assign.to(torch.int32), st.to(torch.int32), basis, None
    A, b, c_full = build_lp_arrays_torch(fp.p_ed, fp.p_es, fp.acc, fp.T)
    maxiter = params.maxiter if params.maxiter is not None else \
        _bucket_maxiter(50 * (A.shape[1] + 2))
    solve = (simplex_batch_grad if params.differentiable
             else simplex_batch_core)
    x, _fun, st, _ni, basis, _ok = solve(
        A, b, c_full, warm_basis, nv=n * (m + 1), maxiter=maxiter,
        tol=params.tol, lane_mask=lane_mask, method=params.lp_method)
    xbar = x.reshape(D, n, m + 1)
    assign, sched_status, _nf = round_relaxation_torch(
        fp.p_ed, fp.p_es, fp.acc, fp.T, xbar.detach(), st,
        frac_tol=params.frac_tol)
    return (assign, sched_status, basis.to(torch.int32),
            xbar if params.differentiable else None)


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


def _fleet_rows(fleet: Optional[FleetAxis], D: int):
    """``(fleet size, this shard's rows)``: the whole fleet unsharded."""
    return (D, slice(0, D)) if fleet is None else fleet.rows(D)


def _arrivals(state: EngineState, params: EngineParams, t: int,
              fleet: Optional[FleetAxis] = None):
    """Release this period's jobs: ``(ci (D, n) int32 class indices,
    take (D,) int32, pending', head')``.  Replay reads the trace; Poisson
    draws the whole fleet's counts and the classes of every release slot
    (a backlogged job takes a fresh class when it is released, which is
    the same distribution for i.i.d. classes).  A shard draws the whole
    fleet (``params.rate`` stays whole in a shard) and keeps its rows."""
    n = params.batch_max
    dev = params.device
    D = params.n_devices
    if params.arrivals == "poisson":
        Dg, rows = _fleet_rows(fleet, D)
        seed = int(state.seed)
        counts_t = torch.poisson(params.rate,
                                 generator=_generator(seed, t, 0, dev))[rows]
        avail = state.pending + counts_t.to(torch.int32)
        take = torch.clamp_max(avail, n).to(torch.int32)
        ci = torch.multinomial(params.class_probs, Dg * n, replacement=True,
                               generator=_generator(seed, t, 1, dev))
        return (ci.reshape(Dg, n)[rows].to(torch.int32), take,
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


def _realization(params: EngineParams, t: int,
                 fleet: Optional[FleetAxis] = None) -> FaultRealization:
    """Period ``t``'s fault realization: entry t mod H of the replayed
    ``fault_trace``, or drawn for (fault_seed, t) on the params' device
    (a shard draws the whole fleet and keeps its rows)."""
    trace = params.fault_trace
    if trace is not None:
        h = t % trace.es_crash.shape[0]
        return FaultRealization(*(x[h] for x in trace))
    Dg, rows = _fleet_rows(fleet, params.n_devices)
    real = sample_realization((params.fault_seed, t), params.faults, Dg,
                              params.batch_max, params.max_retries + 1,
                              device=params.device)
    if fleet is None:
        return real
    return FaultRealization(real.es_crash, *(x[rows] for x in real[1:]))


def _hi_draws(params: EngineParams, t: int):
    """Period ``t``'s HI draws ``(uniforms (D, n, 3), arm_u (D,) or
    None)``: the confidence uniforms from ``hi.conf_trace`` (stream
    "replay", entry t mod H) or drawn for (hi_seed, t); EXP3's arm
    uniforms from ``hi_arm_trace`` (entry t mod H) or drawn for (hi_seed,
    t), None under the other rules."""
    dev, D = params.device, params.n_devices
    if params.hi_stream == "replay":
        trace = params.hi.conf_trace
        uni = trace[t % trace.shape[0]]
    else:
        uni = draw_uniforms(params.hi_seed, t, D, params.batch_max, dev)
    arm_u = None
    if params.hi_rule == "exp3":
        arms = params.hi_arm_trace
        arm_u = (arms[t % arms.shape[0]] if arms is not None
                 else draw_arm_uniforms(params.hi_seed, t, D, dev))
    return uni, arm_u


def _period(belief_p_ed, warm_basis, ci, take, drift_t, outage_t,
            es_tbl, params: EngineParams, *, real=None, link_factor=None,
            covered=None, cell=None, hi_state=None, hi_t=None,
            hi_draws=None, fleet: Optional[FleetAxis] = None):
    """Everything after arrivals and before the state bookkeeping (the
    reference's `_period_impl`), shared by `step` and the host
    `FleetEngine`'s delegation.

    ``es_tbl`` (D, c) is the priced ES table (the audited belief; realized
    execution prices from the true ``params.p_es``).  ``real`` is the
    period's `FaultRealization`, read only under ``params.chaos``.
    Mobility: ``link_factor`` (D,) scales each device's ES times,
    ``covered`` (D,) False disables a device's ES column like an outage,
    ``cell`` (D,) routes admission per cell when ``n_cells`` > 1.  HI
    (read only while armed): ``hi_state`` the incoming `HILearnerState`,
    ``hi_t`` the period, ``hi_draws`` its `_hi_draws`.  ``fleet`` (a
    shard's `FleetAxis`) makes admission global: the shards' demand is
    gathered and every shard admits the whole fleet and keeps its rows,
    or under ``shard_by_cell`` each admits its own and the per-cell loads
    are summed.  The metrics stay this shard's (`_step` reduces them).

    Returns ``(new_belief, new_warm_basis, upd (D,) bool, factor (D,),
    new_es_belief (D, c), cell_load (S,), new_hi_state, metrics dict)``;
    ``factor`` is the EMA rescale each updated device's belief was
    multiplied by (the delegation applies it to its profile tables).  Only
    amr2 carries a basis forward; dual and HI hand ``warm_basis`` back."""
    D, _c, m = belief_p_ed.shape
    n = params.batch_max
    dev = belief_p_ed.device
    f64, i32 = torch.float64, torch.int32
    mask = torch.arange(n, device=dev)[None, :] < take[:, None]
    rows = torch.arange(D, device=dev)[:, None]
    ci = ci.clamp(0, params.p_es.shape[1] - 1)
    p_ed_jobs = torch.where(mask[..., None], belief_p_ed[rows, ci], 0.0)
    base_jobs = torch.where(mask[..., None], params.base_p_ed[rows, ci], 0.0)
    if covered is not None:
        outage_t = outage_t | ~covered      # out of coverage: ES link down

    def _es_jobs(tbl):
        e = torch.where(mask, tbl[rows, ci], 0.0)
        if link_factor is not None:
            e = e * link_factor[:, None]
        return torch.where(outage_t[:, None] & mask, ES_DISABLED_SENTINEL, e)

    p_es_jobs = _es_jobs(es_tbl)
    Tvec = params.T.expand(D)
    fp = FleetProblem.from_arrays_unchecked(p_ed_jobs, p_es_jobs,
                                            params.acc, Tvec, mask)

    # ---- plan the whole fleet in one batched solve, or gate it (HI) -----
    diff = params.differentiable
    hi_armed = params.hi_armed
    new_hi = hi_state
    if hi_armed:
        # every sample runs ``hi_local``; the gate also offloads the
        # low-confidence ones.  No LP runs: the basis passes through.  An
        # outage needs no special case: the disabled ES column prices the
        # intended offloads out of admission, and they stay local below
        lm = params.hi_local
        acc_es_col = params.acc[:, m]
        uni, arm_u = hi_draws
        conf, correct_local, correct_es = sample_confidence(
            None, params.hi, params.acc[:, lm], acc_es_col, ci, uniforms=uni)
        offload_int, _theta, new_hi, _reg = hi_period(
            params.hi_rule, params.hi, hi_state, conf, correct_local,
            correct_es, mask, acc_es_col, hi_t, (params.hi_seed, hi_t),
            params.hi_arms, arm_u=arm_u)
        assign = torch.where(offload_int, m, lm).to(i32)
        basis = (warm_basis.to(i32) if warm_basis is not None
                 else torch.full((D, params.n_basis_rows), -1, dtype=i32,
                                 device=dev))
        n_unsolved = torch.zeros(D, dtype=i32, device=dev)
    else:
        assign, status, basis, xbar = _plan(params, fp, warm_basis)
        unsolved_lane = status == ST_UNSOLVED
        n_unsolved = unsolved_lane.to(i32)
        assign = _recover_unsolved(assign, unsolved_lane, p_ed_jobs, mask,
                                   params.acc, params.T)

    # ---- ES-pool admission: one pool, or per cell ----------------------
    # sharded, every shard admits the gathered global demand and keeps its
    # rows; under ``shard_by_cell`` only the per-cell loads cross
    demand = _slot_sum(torch.where(mask & (assign == m), p_es_jobs, 0.0))
    _Dg, rows_g = _fleet_rows(fleet, D)
    if params.mobility_mode != "off" and params.n_cells > 1:
        if fleet is None or params.shard_by_cell:
            admitted, cloads = admit_mask_segmented(
                demand, cell, params.T, params.n_cells,
                params.servers_per_cell)
            if fleet is not None:
                cloads = fleet.all_reduce(cloads)
        else:
            both = fleet.gather(torch.stack([demand, cell.to(f64)], dim=1))
            admitted, cloads = admit_mask_segmented(
                both[:, 0], both[:, 1].to(i32), params.T, params.n_cells,
                params.servers_per_cell)
            admitted = admitted[rows_g]
        cell_load = _slot_sum(cloads)       # (S,), servers in order
        loads_total = _slot_sum(cell_load[None])[0]
    else:
        admitted, loads, inc = admit_mask_pool(
            demand if fleet is None else fleet.gather(demand), params.T,
            params.n_servers)
        admitted, inc = admitted[rows_g], inc[rows_g]
        loads_total = loads.sum()
        cell_load = loads_total[None]
    offl = demand > 0
    bumped = offl & ~admitted

    # ---- backpressure ---------------------------------------------------
    def _bp_problem():
        p_es_crippled = torch.where(mask, ES_DISABLED_SENTINEL, 0.0)
        return FleetProblem.from_arrays_unchecked(
            p_ed_jobs, p_es_crippled, params.acc, Tvec, mask)

    if hi_armed:
        # no second plan: a bumped device's intended offloads stay on the
        # local model, which every sample ran already
        assign = torch.where(bumped[:, None] & mask, params.hi_local, assign)
    elif diff:
        # the relaxed admission gives every offloader weight on its
        # ES-disabled alternative, so the replan runs on every offloading
        # lane; the hard merge still reads only the bumped ones
        assign_bp, st_bp, _bas, xbar_bp = _plan(params, _bp_problem(), None,
                                                lane_mask=offl)
        unsolved_bp = bumped & (st_bp == ST_UNSOLVED)
        assign_bp = _recover_unsolved(assign_bp, unsolved_bp, p_ed_jobs,
                                      mask, params.acc, params.T)
        assign_pre = assign                 # primary plan, post-recovery
        assign = torch.where(bumped[:, None], assign_bp, assign)
        n_unsolved = n_unsolved + unsolved_bp.to(i32)
    elif bool(bumped.any()):
        # lane-masked ES-disabled replan, skipped on no-bump periods; cold
        # (no basis to factor) and only the bumped lanes pivot
        assign_bp, st_bp, _bas, _x = _plan(
            params, _bp_problem(), None,
            lane_mask=bumped if params.policy == "amr2" else None)
        unsolved_bp = bumped & (st_bp == ST_UNSOLVED)
        assign_bp = _recover_unsolved(assign_bp, unsolved_bp, p_ed_jobs,
                                      mask, params.acc, params.T)
        assign = torch.where(bumped[:, None], assign_bp, assign)
        n_unsolved = n_unsolved + unsolved_bp.to(i32)

    # ---- pricing --------------------------------------------------------
    acc_jobs = params.acc[rows, assign]
    n_jobs = mask.sum().to(i32)
    if hi_armed:
        # every sample runs the local model, offloaded ones too: the ED
        # load prices the whole batch at ``hi_local``
        ed_pred = p_ed_jobs[..., params.hi_local].sum(dim=1)
        ed_wall = base_jobs[..., params.hi_local].sum(dim=1) * drift_t
    else:
        on_ed = mask & (assign < m)
        picked = assign.clamp(0, m - 1).long()[..., None]
        ed_pred = torch.where(on_ed,
                              torch.gather(p_ed_jobs, 2, picked)[..., 0],
                              0.0).sum(dim=1)
        ed_wall = torch.where(on_ed,
                              torch.gather(base_jobs, 2, picked)[..., 0],
                              0.0).sum(dim=1) * drift_t
    es_wall = torch.where(admitted, demand, 0.0)
    es_samp = mask & (assign == m)          # admitted offloads (post-replan)

    # ---- realized execution (chaos): inject faults, walk the ladder -----
    # under a null model every factor is 1.0 and every mask empty, so the
    # realized quantities equal the priced ones bit for bit
    zero_i = torch.zeros((), dtype=i32, device=dev)
    thr = params.straggler_threshold
    if params.chaos:
        lat_local = base_jobs * (drift_t * real.straggler_factor
                                 )[:, None, None]
        rx = realize_execution(
            params.faults, real, mask=mask, es_samp=es_samp,
            acc_jobs=acc_jobs, p_es_jobs=_es_jobs(params.p_es),
            ed_wall=ed_wall, lat_local=lat_local, acc=params.acc,
            T=params.T, max_retries=params.max_retries)
        total_acc = torch.where(mask, rx.acc, 0.0).sum()
        wall = rx.wall
        ed_audit = rx.ed_audit     # excl. fallback: the audit tracks the
        #                            per-op slowdown, not the load
        # chaos -> planner feedback: a device whose realized ES time blew
        # past its priced demand (or that dropped offloads) has its ES
        # belief EMA-inflated
        es_ratio = rx.es_wall / torch.clamp_min(es_wall, 1e-9)
        es_upd = (es_wall > 0) & ((es_ratio > thr) | (rx.n_dropped > 0))
        es_factor = (1.0 - params.ema) + params.ema * torch.clamp_min(
            es_ratio, thr)
        new_es_belief = torch.where(es_upd[:, None],
                                    es_tbl * es_factor[:, None], es_tbl)
        ladder = {
            "n_offload_samples": rx.n_offload.sum().to(i32),
            "n_offload_ok": rx.n_offload_ok.sum().to(i32),
            "n_deadline_miss": rx.n_deadline_miss.sum().to(i32),
            "n_retries": rx.n_retries.sum().to(i32),
            "n_fallback_local": rx.n_fallback_local.sum().to(i32),
            "n_dropped": rx.n_dropped.sum().to(i32),
            "n_es_audit_updates": es_upd.sum().to(i32),
        }
    else:
        if diff:
            total_acc = _smoothed_accuracy(
                params, mask, xbar, xbar_bp, assign_pre, assign_bp, inc,
                admitted, offl)
        elif hi_armed:
            # expected served accuracy under perfect calibration: an
            # admitted offload scores the ES accuracy, a local sample its
            # own confidence (E[correct | conf] == conf)
            total_acc = torch.where(
                mask, torch.where(es_samp, acc_es_col[:, None], conf),
                0.0).sum()
        else:
            total_acc = torch.where(mask, acc_jobs, 0.0).sum()
        wall = torch.maximum(ed_wall, es_wall)
        ed_audit = ed_wall
        new_es_belief = es_tbl
        n_off = es_samp.sum().to(i32)
        ladder = {
            "n_offload_samples": n_off, "n_offload_ok": n_off,
            "n_deadline_miss": zero_i, "n_retries": zero_i,
            "n_fallback_local": zero_i, "n_dropped": zero_i,
            "n_es_audit_updates": zero_i,
        }
    viol = torch.clamp_min(wall / params.T - 1.0, 0.0)

    # ---- EMA straggler audit --------------------------------------------
    ratio = ed_audit / torch.clamp_min(ed_pred, 1e-9)
    upd = (ed_pred > 0) & (ratio > thr)
    factor = (1.0 - params.ema) + params.ema * ratio
    new_belief = torch.where(upd[:, None, None],
                             belief_p_ed * factor[:, None, None],
                             belief_p_ed)

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
        "es_utilization": loads_total / (params.n_servers * params.T),
        "realized_makespan": torch.clamp_min(wall.amax(), 0.0),
        **ladder,
    }
    if hi_armed:
        metrics.update(n_hi_offloaded=es_samp.sum().to(i32),
                       n_hi_local_final=(mask & (assign != m)).sum().to(i32),
                       hi_regret=new_hi.cum_regret.sum())
    else:
        metrics.update(n_hi_offloaded=zero_i, n_hi_local_final=zero_i,
                       hi_regret=torch.zeros((), dtype=f64, device=dev))
    new_warm = basis if params.policy == "amr2" else warm_basis
    return (new_belief, new_warm, upd, factor, new_es_belief, cell_load,
            new_hi, metrics)


def _smoothed_accuracy(params: EngineParams, mask, xbar, xbar_bp,
                       assign_pre, assign_bp, inc, admitted, offl):
    """The differentiable twin of the served accuracy.  Two discrete
    stages are relaxed: Algorithm 2's rounding (temperature-softened
    assignment weights over the LP relaxation) and first-fit admission (a
    sigmoid capacity test on each offloader's inclusive server load
    ``inc``, the value the first fit compared with T).  Per device: the
    primary plan's accuracy and the ES-disabled replan's, blended by the
    admission weight.  Under "st" the forward is the hard decision
    (one-hot weights, the boolean admission) with the soft Jacobians."""
    tau = params.smooth_tau
    if params.smooth_mode == "st":
        wP = straight_through_weights(xbar, assign_pre, tau=tau)
        wBP = straight_through_weights(xbar_bp, assign_bp, tau=tau)
    else:
        wP = soft_assignment_weights(xbar, tau=tau)
        wBP = soft_assignment_weights(xbar_bp, tau=tau)
    accP = torch.where(mask, torch.einsum("dsi,di->ds", wP, params.acc),
                       0.0).sum(dim=1)
    accBP = torch.where(mask, torch.einsum("dsi,di->ds", wBP, params.acc),
                        0.0).sum(dim=1)
    adm_soft = torch.sigmoid((params.T + 1e-12 - inc)
                             / (params.admit_tau * params.T))
    if params.smooth_mode == "st":
        adm_use = adm_soft + (admitted.to(adm_soft.dtype)
                              - adm_soft).detach()
    else:
        adm_use = adm_soft
    dev_acc = torch.where(offl, adm_use * accP + (1.0 - adm_use) * accBP,
                          accP)
    return dev_acc.sum()


def _positions(state: EngineState, params: EngineParams, t: int,
               fleet: Optional[FleetAxis] = None):
    """Period ``t``'s device positions: the replayed trace (cycled), or
    under the walk the last positions plus ``walk_sigma`` x normal steps
    drawn for (mobility_seed, t) on the params' device (a shard draws the
    whole fleet's steps and keeps its rows)."""
    mob = params.mobility
    if params.mobility_mode == "replay":
        return mob.trace[t % mob.trace.shape[0]]
    Dg, rows = _fleet_rows(fleet, params.n_devices)
    steps = torch.randn((Dg, 2), generator=_generator(
        params.mobility_seed, t, 5, params.device), dtype=torch.float64,
        device=params.device)
    return state.pos + mob.walk_sigma * steps[rows]


def _step(state: EngineState, params: EngineParams,
          fleet: Optional[FleetAxis] = None
          ) -> Tuple[EngineState, PeriodMetrics]:
    """One period: mobility, arrivals, `_period`, state and metric
    assembly; for a shard (``fleet``) the metrics are reduced over the
    shards (`_reduce_metrics`)."""
    t = int(state.period)
    dev = params.device
    D = params.n_devices
    H = params.drift.shape[1]
    drift_t = params.drift[:, t % H]
    outage_t = params.outage[:, t % H]
    # a basis optimal for last period's LP is meaningless when the ES
    # column set changed underneath it (outage flipped on/off): cold-start
    # those lanes
    stale = (params.outage[:, (t - 1) % H] != outage_t if t > 0
             else torch.zeros(D, dtype=torch.bool, device=dev))
    # ---- mobility: move, route, detect handover -------------------------
    link_factor = covered = None
    es_belief0 = state.p_es_belief
    pos_t, cell_t = state.pos, state.cell
    n_handover = torch.zeros((), dtype=torch.int32, device=dev)
    if params.mobility_mode != "off":
        mob = params.mobility
        pos_t = _positions(state, params, t, fleet)
        load_frac = state.cell_load / (params.servers_per_cell * params.T)
        cell_t, covered, link_factor = route_cells(pos_t, mob, load_frac,
                                                   params.routing)
        # handover: the old cell's basis labels an LP whose ES column was
        # priced for another link — cold-start it, and reset the ES belief
        # to the nominal table
        if t > 0:
            switched = cell_t != state.cell
            stale = stale | switched
            es_belief0 = torch.where(switched[:, None], params.p_es,
                                     state.p_es_belief)
            n_handover = switched.sum().to(torch.int32)
    warm0 = torch.where(stale[:, None], -1, state.warm_basis)
    ci, take, pending, head = _arrivals(state, params, t, fleet)
    real = _realization(params, t, fleet) if params.chaos else None
    hi_draws = _hi_draws(params, t) if params.hi_armed else None
    (new_belief, new_warm, upd, _factor, new_es_belief, cell_load, new_hi,
     m) = _period(state.p_ed, warm0, ci, take, drift_t, outage_t,
                  es_belief0, params, real=real, link_factor=link_factor,
                  covered=covered, cell=cell_t, hi_state=state.hi, hi_t=t,
                  hi_draws=hi_draws, fleet=fleet)
    m = dict(m, backlog=pending.sum().to(torch.int32), n_handover=n_handover)
    if fleet is not None:
        m = _reduce_metrics(fleet, m)
    n_jobs = m["n_jobs"]
    metrics = PeriodMetrics(
        period=state.period.clone(),
        mean_job_accuracy=torch.where(
            n_jobs > 0, m["total_accuracy"] / torch.clamp_min(n_jobs, 1),
            0.0), **m)
    new_state = EngineState(
        period=state.period + 1, p_ed=new_belief, pending=pending,
        head=head, warm_basis=new_warm.to(torch.int32),
        n_updates=(state.n_updates + upd.to(torch.int32)),
        pos=pos_t, cell=cell_t.to(torch.int32), cell_load=cell_load,
        p_es_belief=new_es_belief, seed=state.seed, hi=new_hi)
    return new_state, metrics


# how a shard's metrics combine: float sums, float maxima, and the ES
# utilization every shard already computes from the global admission;
# every other metric is a counter, summed
_SHARD_SUMS = ("total_accuracy", "hi_regret")
_SHARD_MAXES = ("worst_violation", "realized_makespan")
_SHARD_GLOBAL = ("es_utilization",)


def _reduce_metrics(fleet: FleetAxis, m: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """A shard's period metrics made global in three collectives (one
    int64 SUM vector of the counters, one float64 SUM, one float64 MAX)."""
    counters = {k: v for k, v in m.items()
                if k not in _SHARD_SUMS + _SHARD_MAXES + _SHARD_GLOBAL}
    return {**m, **fleet.reduce_metrics(
        counters, {k: m[k] for k in _SHARD_SUMS},
        {k: m[k] for k in _SHARD_MAXES})}


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def _leaves(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of a params/state value by dotted name, those of its
    scenario models (dataclasses, named tuples) included."""
    if isinstance(obj, tuple):
        items = obj._asdict().items()
    else:
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    out = {}
    for name, leaf in items:
        if isinstance(leaf, torch.Tensor):
            out[prefix + name] = leaf
        elif dataclasses.is_dataclass(leaf) or hasattr(leaf, "_asdict"):
            out.update(_leaves(leaf, f"{prefix}{name}."))
    return out


def _require_f64(tag: str, obj) -> None:
    """Reject floating tensors that are not float64 instead of computing
    with them: the engine is float64 end to end (the LP parity contract)."""
    for name, leaf in _leaves(obj).items():
        if leaf.is_floating_point() and leaf.dtype != torch.float64:
            raise TypeError(f"{tag}.{name} is {leaf.dtype} but the engine "
                            f"is float64-only; build tensors as float64")


def _entry_device(params: EngineParams, state: Optional[EngineState],
                  device: DeviceLike) -> torch.device:
    """Resolve the call's device (CUDA unless named) and check that params
    and state live there."""
    dev = resolve_device(device)
    check_device("params", _leaves(params), dev)
    if state is not None:
        check_device("state", _leaves(state), dev)
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
    if params.hi_armed and state.hi is None:
        raise ValueError("HI is armed but the state carries no learner "
                         "(EngineState.hi); build it with init_state")


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
    return _roll(state, params, periods)


def _roll(state: EngineState, params: EngineParams, periods: int,
          fleet: Optional[FleetAxis] = None
          ) -> Tuple[EngineState, PeriodMetrics]:
    history = []
    for _ in range(int(periods)):
        state, m = _step(state, params, fleet)
        history.append(m)
    return state, PeriodMetrics(**{
        f: torch.stack([getattr(m, f) for m in history])
        for f in METRIC_FIELDS})


# --------------------------------------------------------------------------
# differentiation: the float / non-float split and rollout gradients
# --------------------------------------------------------------------------
# the placeholder of a tensor in the half it does not belong to
_NONDIFF = None


def _split(obj, floating: bool):
    if isinstance(obj, torch.Tensor):
        return obj if obj.is_floating_point() == floating else _NONDIFF
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = object.__new__(type(obj))
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name,
                               _split(getattr(obj, f.name), floating))
        return out
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_split(x, floating) for x in obj))
    return obj                 # configuration: kept in both halves


def partition_diff(obj):
    """Split a params or state value into ``(diff, nondiff)`` halves of
    its own type: floating tensors keep their value in ``diff`` and are
    ``None`` in ``nondiff``; integer and bool tensors (warm bases, cursors,
    counters, masks) go the other way; configuration stays in both.
    Nested models (faults, mobility, HI) split the same way, and
    `combine_diff` reassembles the value."""
    return _split(obj, True), _split(obj, False)


def combine_diff(diff, nondiff):
    """Inverse of `partition_diff`: each tensor from whichever half holds
    it."""
    if isinstance(diff, torch.Tensor) or isinstance(nondiff, torch.Tensor):
        return diff if nondiff is _NONDIFF else nondiff
    if dataclasses.is_dataclass(diff) and not isinstance(diff, type):
        out = object.__new__(type(diff))
        for f in dataclasses.fields(diff):
            object.__setattr__(out, f.name, combine_diff(
                getattr(diff, f.name), getattr(nondiff, f.name)))
        return out
    if isinstance(diff, tuple) and hasattr(diff, "_fields"):
        return type(diff)(*(combine_diff(a, b)
                            for a, b in zip(diff, nondiff)))
    return diff


def rollout_value_and_grad(state: EngineState, params: EngineParams,
                           periods: int, *,
                           wrt: Optional[Sequence[str]] = None,
                           device: DeviceLike = None):
    """``(value, grads)``: the epoch's summed ``total_accuracy`` and its
    gradient with respect to the named `EngineParams` tensors (default:
    ``params.grad_leaves``), as a dict keyed by name, each shaped like its
    tensor.

    The periods run under autograd: the LP differentiated implicitly at
    its converged basis (`lp.simplex_batch_grad`), rounding and admission
    relaxed per ``smooth_mode`` ("st": the value is the hard rollout's
    served accuracy; "soft": the relaxed surrogate finite differences
    check).  The beliefs are re-rooted at the differentiated tables (the
    period prices from ``state.p_ed`` and ``state.p_es_belief``, which
    `init_state` copies from them); without that every gradient with
    respect to ``p_es`` and ``base_p_ed`` would be zero.  Needs
    `EngineParams.with_differentiable`."""
    if not params.differentiable:
        raise ValueError(
            "rollout_grad/rollout_value_and_grad need "
            "params.with_differentiable(): with the flag off the period is "
            "the hard (piecewise-constant) path and every gradient would "
            "be zero")
    _checked(state, params, int(periods), device)
    wrt = tuple(wrt) if wrt is not None else tuple(params.grad_leaves)
    _check_grad_leaves("wrt", wrt)
    leaves = {f: getattr(params, f).detach().clone().requires_grad_(True)
              for f in wrt}
    with torch.enable_grad():
        p = dataclasses.replace(params, **leaves)
        s = dataclasses.replace(state, p_ed=p.base_p_ed,
                                p_es_belief=p.p_es)
        total = []
        for _ in range(int(periods)):
            s, m = _step(s, p)
            total.append(m.total_accuracy)
        value = torch.stack(total).sum()
        grads = torch.autograd.grad(value, [leaves[f] for f in wrt],
                                    allow_unused=True)
    return value.detach(), {
        f: (g if g is not None else torch.zeros_like(leaves[f]))
        for f, g in zip(wrt, grads)}


def rollout_grad(state: EngineState, params: EngineParams, periods: int,
                 *, wrt: Optional[Sequence[str]] = None,
                 device: DeviceLike = None):
    """`rollout_value_and_grad` without the value."""
    return rollout_value_and_grad(state, params, periods, wrt=wrt,
                                  device=device)[1]


# --------------------------------------------------------------------------
# sharding: one process per shard of the fleet axis (`_mesh`)
# --------------------------------------------------------------------------
def _reject_diff_sharded(params: EngineParams) -> None:
    """Gradients run on the unsharded rollout: the relaxed pricing and the
    unconditional replan have no sharded twin, so a sharded
    "differentiable" rollout would run the hard forward."""
    if params.differentiable:
        raise ValueError(
            "sharded entry points do not support differentiable params; "
            "disarm with with_differentiable(False) or run "
            "rollout_value_and_grad on the single-host trace")


def _reject_hi_sharded(params: EngineParams) -> None:
    """Armed HI carries a learner whose sharded bookkeeping the reference
    has not validated either: refused, as there."""
    if params.hi_armed:
        raise ValueError(
            "sharded entry points do not support armed HI "
            f"(hi_rule={params.hi_rule!r}); disarm with with_hi(None) or "
            "run the single-host rollout")


def shard(state: EngineState, params: EngineParams, mesh
          ) -> Tuple[EngineState, EngineParams]:
    """This rank's block of ``state`` and ``params`` on ``mesh``
    (`fleet_mesh`): rows ``[rank·D/n, (rank+1)·D/n)`` of every per-device
    tensor (along the device axis of ``counts``, the mobility ``trace``
    and the replayed ``fault_trace``), scalars and class tables whole.
    ``rate`` stays whole too: a shard's Poisson draw is the whole fleet's
    (`_arrivals`).  The fleet size must divide the mesh.  Tensors stay on
    their device."""
    _reject_hi_sharded(params)
    _require_f64("state", state)
    _require_f64("params", params)
    axis = FleetAxis.of(mesh, params.device)
    D = params.n_devices
    if D % axis.size:
        raise ValueError(
            f"fleet size {D} does not divide the {axis.size}-device mesh")
    _Dg, rows = axis.rows(D // axis.size)

    def cut(x, dim=0):
        return x.narrow(dim, rows.start, rows.stop - rows.start).clone()

    mob = params.mobility
    if params.mobility_mode != "off":
        mob = dataclasses.replace(mob, trace=cut(mob.trace, 1))
    trace = params.fault_trace
    if trace is not None:
        trace = FaultRealization(trace.es_crash,
                                 *(cut(x, 1) for x in trace[1:]))
    local_params = dataclasses.replace(
        params, **{f: cut(getattr(params, f))
                   for f in ("base_p_ed", "p_es", "acc", "drift", "outage",
                             "stream")},
        counts=cut(params.counts, 1), mobility=mob, fault_trace=trace)
    local_state = dataclasses.replace(
        state, **{f: cut(getattr(state, f))
                  for f in ("p_ed", "pending", "head", "warm_basis",
                            "n_updates", "pos", "cell", "p_es_belief")},
        hi=(None if state.hi is None
            else HILearnerState(*(cut(getattr(state.hi, f))
                                  for f in HI_STATE_FIELDS))))
    return local_state, local_params


def _sharded_axis(state, params, periods, mesh, device) -> FleetAxis:
    """The guards of the sharded entry points and this shard's axis."""
    _reject_diff_sharded(params)
    _reject_hi_sharded(params)
    _checked(state, params, periods, device)
    axis = FleetAxis.of(mesh, params.device)
    if params.rate.shape[0] != axis.size * params.n_devices:
        raise ValueError(
            f"params hold {params.n_devices} devices and "
            f"{params.rate.shape[0]} Poisson rates on a {axis.size}-shard "
            f"mesh; pass the block `shard(state, params, mesh)` returns")
    return axis


def step_sharded(state: EngineState, params: EngineParams, mesh, *,
                 device: DeviceLike = None
                 ) -> Tuple[EngineState, PeriodMetrics]:
    """`step` of this rank's shard (`shard`): returns the shard's next
    state and the fleet's metrics, equal on every rank to the unsharded
    `step`'s (float sums to rounding).  Every rank of the mesh calls it."""
    axis = _sharded_axis(state, params, 1, mesh, device)
    return _step(state, params, axis)


def rollout_sharded(state: EngineState, params: EngineParams, periods: int,
                    mesh, *, device: DeviceLike = None
                    ) -> Tuple[EngineState, PeriodMetrics]:
    """`rollout` of this rank's shard (`shard`): ``(the shard's final
    state, the fleet's metrics stacked to (periods,))``, the metrics equal
    on every rank to the unsharded rollout's (float sums to rounding).
    Every rank of the mesh calls it with the same ``periods``."""
    return _roll(state, params, periods,
                 _sharded_axis(state, params, periods, mesh, device))
