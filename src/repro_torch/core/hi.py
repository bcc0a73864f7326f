"""Online hierarchical inference: confidence-gated per-sample offloading
with in-rollout learning (port of `repro.core.hi`).

AMR^2 plans from a known accuracy table.  In the online twin of the
problem (Moothedath & Champati, arXiv 2304.00891) the ED runs its small
local model on every sample, observes a confidence for the local
prediction, and decides per sample from that confidence alone whether to
also offload.  Offloading buys the ES accuracy at a fixed per-sample cost
``beta`` (``offload_cost``), so under a calibrated confidence the
clairvoyant rule is a threshold: offload iff ``conf < theta*`` with
``theta* = acc_es - beta``.  The rules compete with that clairvoyant:

``"fixed"``
    A constant threshold ``theta0`` (a per-device ``theta0 = clip(acc_es
    - beta, 0, 1)`` is the clairvoyant and accrues exactly zero regret).
``"threshold"``
    Online gradient descent on the threshold with a sigmoid-kernel
    surrogate gradient and a ``lr / sqrt(t+1)`` step; its stationary
    point is ``a_hat_es - beta`` with ``a_hat_es`` the running ES-accuracy
    estimate from the learner's own offloads (optimistic prior 1.0).
``"ucb"`` / ``"exp3"``
    Bandits over ``n_arms`` thresholds (`arm_grid`): one arm a device a
    period, rewarded with the period's mean realized per-sample reward.

`HIModel` keeps its scalar hyper-parameters as Python floats (the
`FaultModel` idiom: exact float64 scalars that combine with tensors on
any device) and ``spread``, ``theta0`` and ``conf_trace`` as float64
tensors (`HIModel.to` moves them).  `HILearnerState` is the learner's
state, one row per device, carried by the engine's `EngineState`.

Random streams: torch cannot redraw jax's threefry streams.  The
confidence uniforms (D, n, 3) of period t are drawn for the whole fleet
at once on the given device from a generator seeded by (hi_seed, t)
(`_device.seeded_generator`), so a device's draw depends only on the
seed, the period and its index; `presample_stream` reproduces that
stream bit for bit, so replay equals fold, and a trace drawn on the card
replays on the CPU.  EXP3 draws one arm uniform a device a period from
its own stream of the same seed (the reference draws it from the second
half of the period's split key, under replay too): the engine's
port-only ``hi_arm_trace`` replays those draws.  Parity runs replay the
reference's `presample_stream` and arm draws.

Calibration: per-sample confidence is ``p = mu + spread_c *
(u**((1-mu)/mu) - mu)`` with ``mu`` the local model's table accuracy, so
``E[p] = mu`` for any spread in [0, 1]; the local outcome is Bernoulli in
that confidence (``P(correct | conf) == conf``).

Every per-device sum over a period's samples (and EXP3's sums over arms)
runs in slot order (`core.problem.slot_sum`), so the card and the CPU
agree bit for bit on the learner's state.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device, seeded_generator
from .problem import slot_sum

__all__ = [
    "HI_RULES", "HI_STREAMS", "EXP3_GAMMA",
    "HIModel", "HILearnerState",
    "arm_grid", "draw_uniforms", "draw_arm_uniforms", "sample_confidence",
    "presample_stream", "hi_period", "validate_hi",
]

HI_RULES = ("fixed", "threshold", "ucb", "exp3")
HI_STREAMS = ("fold", "replay")
# EXP3's exploration floor (uniform mixing weight); its learning rate is
# the model's ``explore``
EXP3_GAMMA = 0.1
# `seeded_generator` streams (arrivals 0-1, faults 2-4, the walk 5)
CONF_STREAM, ARM_STREAM = 6, 7


def _f64(x) -> torch.Tensor:
    """A float64 tensor: tensors keep their device, the rest go to the
    CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64))


@dataclasses.dataclass(frozen=True)
class HIModel:
    """Calibration curves and learner hyper-parameters."""

    spread: torch.Tensor      # (c,) or (1,) per-class calibration spread
    offload_cost: float       # beta: per-sample cost of consulting the ES
    lr: float                 # OGD step size (decayed by 1/sqrt(t+1))
    tau: float                # surrogate sigmoid temperature
    theta0: torch.Tensor      # () or (D,) initial / fixed threshold
    explore: float            # UCB bonus coefficient / EXP3 rate
    conf_trace: torch.Tensor  # (H, D, n, 3) replayed uniforms; (1, 1, 1,
    #                           3) placeholder when the stream is drawn

    @classmethod
    def none(cls) -> "HIModel":
        """The null model: HI disarmed."""
        return cls(spread=torch.zeros(1, dtype=torch.float64),
                   offload_cost=0.0, lr=0.0, tau=1.0,
                   theta0=torch.tensor(0.5, dtype=torch.float64),
                   explore=0.0,
                   conf_trace=torch.zeros((1, 1, 1, 3), dtype=torch.float64))

    @classmethod
    def make(cls, *, spread=0.8, offload_cost: float = 0.15,
             lr: float = 0.2, tau: float = 0.05, theta0=0.5,
             explore: float = 0.5, conf_trace=None) -> "HIModel":
        """Keyword constructor with the reference's range checks.
        ``spread`` is a scalar or per-class vector in [0, 1]; ``theta0`` a
        scalar or per-device vector in [0, 1]; ``conf_trace`` (periods, D,
        n, 3) uniforms (an array, or a tensor kept on its device)."""
        sp = torch.atleast_1d(_f64(spread))
        if sp.dim() != 1 or bool((sp < 0).any()) or bool((sp > 1).any()):
            raise ValueError("spread must be scalar or 1-D in [0, 1]")
        if not 0.0 <= float(offload_cost) < 1.0:
            raise ValueError("offload_cost must be in [0, 1)")
        if lr <= 0 or tau <= 0:
            raise ValueError("lr and tau must be > 0")
        th = _f64(theta0)
        if bool((th < 0).any()) or bool((th > 1).any()) or th.dim() > 1:
            raise ValueError("theta0 must be scalar or 1-D in [0, 1]")
        if explore < 0:
            raise ValueError("explore must be >= 0")
        if conf_trace is None:
            tr = torch.zeros((1, 1, 1, 3), dtype=torch.float64)
        else:
            tr = _f64(conf_trace)
            if tr.dim() != 4 or tr.shape[3] != 3:
                raise ValueError(
                    f"conf_trace must be (periods, D, n, 3) uniforms; "
                    f"got {tuple(tr.shape)}")
        return cls(spread=sp, offload_cost=float(offload_cost),
                   lr=float(lr), tau=float(tau), theta0=th,
                   explore=float(explore), conf_trace=tr)

    @classmethod
    def from_profiles(cls, p_ed, *, spread_range: Tuple[float, float]
                      = (0.35, 0.95), **kw) -> "HIModel":
        """Per-class spreads from the latency profiles: classes ranked by
        their mean ED latency, the spread interpolating ``spread_range``
        over that rank (slower classes swing further).  ``p_ed`` is a (c,
        m) table or the engine's (D, c, m) ``base_p_ed``; other keywords
        go to `make`."""
        tbl = (p_ed.detach().cpu().numpy() if isinstance(p_ed, torch.Tensor)
               else np.asarray(p_ed, np.float64))
        if tbl.ndim == 3:
            tbl = tbl.mean(axis=0)
        if tbl.ndim != 2:
            raise ValueError(f"p_ed must be (c, m) or (D, c, m); got "
                             f"shape {tbl.shape}")
        c = tbl.shape[0]
        lo, hi = spread_range
        if not 0.0 <= lo <= hi <= 1.0:
            raise ValueError("spread_range must satisfy 0 <= lo <= hi <= 1")
        if c == 1:
            sp = np.array([(lo + hi) / 2.0])
        else:
            rank = np.argsort(np.argsort(tbl.mean(axis=1)))
            sp = lo + (hi - lo) * rank / (c - 1)
        return cls.make(spread=sp, **kw)

    def is_null(self) -> bool:
        """No confidence signal and no learner."""
        return (float(self.spread.max()) == 0.0
                and self.offload_cost == 0.0 and self.lr == 0.0
                and self.explore == 0.0)

    def to(self, device: DeviceLike) -> "HIModel":
        """The model with its tensors on ``device``."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, spread=self.spread.to(dev), theta0=self.theta0.to(dev),
            conf_trace=self.conf_trace.to(dev))


HI_MODEL_FIELDS = tuple(f.name for f in dataclasses.fields(HIModel))


@dataclasses.dataclass(frozen=True)
class HILearnerState:
    """The learner's state, one row per device, tensors on one device.
    Counts are float64: they feed ratios and bonuses directly."""

    theta: torch.Tensor       # (D,) current threshold
    arm: torch.Tensor         # (D,) int32 last pulled arm (bandit rules)
    arms_sum: torch.Tensor    # (D, K) per-arm reward sum (UCB) / EXP3 gains
    arms_cnt: torch.Tensor    # (D, K) per-arm pull counts
    es_sum: torch.Tensor      # (D,) observed ES-correct count
    es_cnt: torch.Tensor      # (D,) observed offload count
    cum_regret: torch.Tensor  # (D,) cumulative pseudo-regret vs theta*

    @classmethod
    def init(cls, n_devices: int, n_arms: int, theta0=0.5, *,
             device: DeviceLike = None) -> "HILearnerState":
        """A fresh learner at ``theta0`` on ``device`` (the card unless
        named)."""
        dev = resolve_device(device)
        D, K = n_devices, n_arms
        f64 = dict(dtype=torch.float64, device=dev)
        th = _f64(theta0).to(dev).expand(D).clone()
        return cls(theta=th, arm=torch.zeros(D, dtype=torch.int32,
                                              device=dev),
                   arms_sum=torch.zeros((D, K), **f64),
                   arms_cnt=torch.zeros((D, K), **f64),
                   es_sum=torch.zeros(D, **f64), es_cnt=torch.zeros(D, **f64),
                   cum_regret=torch.zeros(D, **f64))

    def to(self, device: DeviceLike) -> "HILearnerState":
        return HILearnerState(*(getattr(self, f).to(device)
                                for f in HI_STATE_FIELDS))


HI_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(HILearnerState))


def _fma(a: float, b: float, c: float) -> float:
    """``a * b + c`` with one rounding."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def arm_grid(n_arms: int, device: DeviceLike = "cpu") -> torch.Tensor:
    """The bandits' thresholds: K evenly spaced interior points of [0, 1]
    (K = 9 gives 0.1 .. 0.9).  The points are the reference's to the last
    bit: its ``jnp.linspace(start, stop, K)`` compiles on the CPU to
    ``start * (1 - i*r) + i * (stop*r)`` with ``r = 1/(K-1)``, each
    product rounded except the one the final add fuses (``i*(stop*r)``
    from i = 2 on, ``start*(1 - r)`` at i = 1), and ``stop`` itself last.
    Computed on the host, so every device holds the same bits."""
    start, stop = 1.0 / (n_arms + 1), n_arms / (n_arms + 1.0)
    div = n_arms - 1
    grid = [start]
    if div > 0:
        r = 1.0 / div
        c = stop * r
        for i in range(1, div):
            sub = 1.0 - float(i) * r
            grid.append(_fma(start, sub, c) if i == 1
                        else _fma(float(i), c, start * sub))
        grid.append(stop)
    return torch.tensor(grid, dtype=torch.float64, device=device)


def draw_uniforms(seed: int, period: int, n_devices: int, n_jobs: int,
                  device: torch.device) -> torch.Tensor:
    """Period ``period``'s (D, n, 3) confidence uniforms for the whole
    fleet, drawn on ``device`` for (seed, period): channel 0 shapes the
    confidence, 1 the local outcome, 2 the ES outcome."""
    return torch.rand((n_devices, n_jobs, 3), dtype=torch.float64,
                      device=device, generator=seeded_generator(
                          seed, period, CONF_STREAM, device))


def draw_arm_uniforms(seed: int, period: int, n_devices: int,
                      device: torch.device) -> torch.Tensor:
    """Period ``period``'s (D,) EXP3 arm-draw uniforms, drawn on
    ``device`` for (seed, period)."""
    return torch.rand((n_devices,), dtype=torch.float64, device=device,
                      generator=seeded_generator(seed, period, ARM_STREAM,
                                                 device))


def presample_stream(seed: int, n_devices: int, n_jobs: int, periods: int,
                     *, device: DeviceLike = None) -> torch.Tensor:
    """A replayed confidence trace ``(periods, D, n, 3)`` on ``device``
    (the card unless named) holding, bit for bit, the uniforms an armed
    engine with ``hi_seed=seed`` draws on that device at each period:
    ``HIModel.make(conf_trace=...)`` with ``stream="replay"`` then
    reproduces the drawn rollout."""
    dev = resolve_device(device)
    return torch.stack([draw_uniforms(seed, t, n_devices, n_jobs, dev)
                        for t in range(periods)])


def sample_confidence(key: Optional[Tuple[int, int]], hm: HIModel,
                      acc_local, acc_es, ci, *, uniforms=None):
    """One period of the calibrated confidence stream.

    ``acc_local`` (D,) is the designated local model's table accuracy,
    ``acc_es`` (D,) the ES accuracy, ``ci`` (D, n) per-sample class
    indices; ``uniforms`` (D, n, 3) replays a presampled slice, else the
    draw is `draw_uniforms` for ``key`` = (seed, period).  Returns
    ``(conf, correct_local, correct_es)``, each (D, n)."""
    D, n = ci.shape
    u = (draw_uniforms(key[0], key[1], D, n, ci.device) if uniforms is None
         else uniforms)
    mu = acc_local.clamp(1e-6, 1.0 - 1e-6)
    p_raw = u[..., 0] ** ((1.0 - mu) / mu)[:, None]
    sp = hm.spread
    spread_j = sp[ci.long()] if sp.shape[0] > 1 else sp[0]
    conf = (mu[:, None] + spread_j * (p_raw - mu[:, None])).clamp(0.0, 1.0)
    correct_local = u[..., 1] < conf
    correct_es = u[..., 2] < acc_es[:, None]
    return conf, correct_local, correct_es


def _arm_order_cumsum(p: torch.Tensor) -> torch.Tensor:
    """(D, K) running sums over the arm axis, added in arm order."""
    out = [p[:, 0]]
    for k in range(1, p.shape[1]):
        out.append(out[-1] + p[:, k])
    return torch.stack(out, dim=1)


def hi_period(rule: str, hm: HIModel, hst: HILearnerState, conf,
              correct_local, correct_es, mask, acc_es, t: int,
              key: Optional[Tuple[int, int]], n_arms: int, *, arm_u=None):
    """One HI period: this period's threshold, the per-sample decisions,
    the learner's update from the observations, and the pseudo-regret.

    ``conf``/``correct_local``/``correct_es`` come from
    `sample_confidence`, ``mask`` (D, n) marks real samples, ``acc_es``
    (D,) is the true ES accuracy (read only by the regret metric), ``t``
    the period (step-size decay, the UCB bonus).  EXP3 reads ``arm_u``
    (D,) arm uniforms, or draws them for ``key`` = (seed, period).

    Returns ``(offload (D, n) bool — the intended decisions, theta_t
    (D,), new_state, regret_inc (D,))``; the regret increment is the
    expected pseudo-regret of the decisions against ``theta* = acc_es -
    beta`` given the realized confidences (>= 0, exactly 0 for the
    clairvoyant)."""
    if rule not in HI_RULES:
        raise ValueError(f"unknown HI rule {rule!r}; expected one of "
                         f"{HI_RULES}")
    D, _n = conf.shape
    dev = conf.device
    f64 = torch.float64
    beta = hm.offload_cost
    njobs = mask.sum(dim=1).to(f64)
    has = njobs > 0
    tf = float(t)
    probs = None

    # ---- this period's threshold per device -----------------------------
    if rule == "ucb":
        grid = arm_grid(n_arms, dev)
        cnt = hst.arms_cnt
        mean = hst.arms_sum / cnt.clamp_min(1.0)
        # untried arms get an infinite bonus: argmax (first maximum) sweeps
        # the grid in index order before any exploitation starts.  The
        # bonus of each count is computed on the host, each operation
        # correctly rounded, and gathered: the card's float64 sqrt differs
        # from the CPU's in the last bit, and arms whose means tie to an
        # ulp then rank otherwise
        log_t = math.log(tf + 2.0)
        table = torch.tensor(
            [math.inf] + [hm.explore * math.sqrt(log_t / c)
                          for c in range(1, int(cnt.max()) + 1)],
            dtype=f64, device=dev)
        bonus = table[cnt.long()]
        arm = (mean + bonus).argmax(dim=1).to(torch.int32)
        theta_t = grid[arm.long()]
    elif rule == "exp3":
        grid = arm_grid(n_arms, dev)
        g = hm.explore * hst.arms_sum
        g = g - g.amax(dim=1, keepdim=True)
        w = torch.exp(g)
        probs = ((1.0 - EXP3_GAMMA) * w / slot_sum(w)[:, None]
                 + EXP3_GAMMA / n_arms)
        u = (draw_arm_uniforms(key[0], key[1], D, dev) if arm_u is None
             else arm_u)
        cdf = _arm_order_cumsum(probs)
        arm = torch.clamp_max((u[:, None] >= cdf).sum(dim=1),
                              n_arms - 1).to(torch.int32)
        theta_t = grid[arm.long()]
    else:                                       # "fixed" / "threshold"
        theta_t = hst.theta
        arm = hst.arm

    offload = mask & (conf < theta_t[:, None])

    # ---- the learner's update from the period's observations ------------
    # running ES-accuracy estimate with an optimistic prior at 1.0: an
    # untried ES looks perfect, so early thresholds drift up and explore
    a_hat = (hst.es_sum + 1.0) / (hst.es_cnt + 1.0)
    new_es_sum = hst.es_sum + (offload & correct_es).sum(dim=1).to(f64)
    new_es_cnt = hst.es_cnt + offload.sum(dim=1).to(f64)

    if rule == "threshold":
        # sigmoid-kernel surrogate gradient of the per-sample threshold
        # loss; stationary at theta = a_hat - beta
        z = (theta_t[:, None] - conf) / hm.tau
        sig = torch.sigmoid(z)
        ker = sig * (1.0 - sig) / hm.tau
        gsamp = ker * (beta - a_hat[:, None] + correct_local.to(f64))
        gmean = (slot_sum(torch.where(mask, gsamp, 0.0))
                 / njobs.clamp_min(1.0))
        step = hm.lr / math.sqrt(tf + 1.0)
        new_theta = torch.where(
            has, (theta_t - step * gmean).clamp(0.0, 1.0), theta_t)
    else:
        new_theta = theta_t

    if rule in ("ucb", "exp3"):
        # realized per-sample reward: the ES answer minus the offload cost
        # when consulted, else the local outcome
        r = torch.where(offload, correct_es.to(f64) - beta,
                        correct_local.to(f64))
        r_mean = slot_sum(torch.where(mask, r, 0.0)) / njobs.clamp_min(1.0)
        onehot = (torch.arange(n_arms, dtype=torch.int32, device=dev)[None, :]
                  == arm[:, None])
        upd = has[:, None] & onehot
        if rule == "ucb":
            new_sum = hst.arms_sum + torch.where(upd, r_mean[:, None], 0.0)
        else:
            r01 = (r_mean + beta) / (1.0 + beta)      # EXP3 wants [0, 1]
            p_arm = torch.gather(probs, 1, arm.long()[:, None])[:, 0]
            ghat = r01 / p_arm.clamp_min(1e-9)       # importance weight
            new_sum = hst.arms_sum + torch.where(upd, ghat[:, None], 0.0)
        new_cnt = hst.arms_cnt + upd.to(f64)
    else:
        new_sum, new_cnt = hst.arms_sum, hst.arms_cnt

    # ---- pseudo-regret vs the clairvoyant theta* = acc_es - beta --------
    r_es = acc_es[:, None] - beta
    chosen = torch.where(offload, r_es, conf)
    regret_inc = slot_sum(torch.where(mask, torch.maximum(conf, r_es)
                                      - chosen, 0.0))

    new_hst = HILearnerState(
        theta=new_theta, arm=arm, arms_sum=new_sum, arms_cnt=new_cnt,
        es_sum=new_es_sum, es_cnt=new_es_cnt,
        cum_regret=hst.cum_regret + regret_inc)
    return offload, theta_t, new_hst, regret_inc


def validate_hi(hm: HIModel, *, n_devices: int, n_classes: int,
                n_models: int, rule: str, stream: str, n_arms: int,
                local_model: int, batch_max: Optional[int] = None) -> None:
    """Arming checks, with the reference's messages: shapes and ranges a
    period could only fail on silently."""
    if rule not in HI_RULES:
        raise ValueError(f"unknown HI rule {rule!r}; expected one of "
                         f"{HI_RULES} (or disarm with with_hi(None))")
    if stream not in HI_STREAMS:
        raise ValueError(f"unknown HI stream {stream!r}; expected one of "
                         f"{HI_STREAMS}")
    sp = tuple(hm.spread.shape)
    if sp not in ((1,), (n_classes,)):
        raise ValueError(
            f"HIModel.spread has shape {sp}; expected (1,) or one "
            f"entry per queue class ({n_classes},)")
    th = tuple(hm.theta0.shape)
    if len(th) not in (0, 1) or (len(th) == 1 and th != (n_devices,)):
        raise ValueError(
            f"HIModel.theta0 has shape {th}; expected a scalar or "
            f"one entry per device ({n_devices},)")
    if rule in ("ucb", "exp3") and n_arms < 2:
        raise ValueError(f"bandit rules need n_arms >= 2; got {n_arms}")
    if not 0 <= local_model < n_models:
        raise ValueError(
            f"hi_local={local_model} is not a local model index; the "
            f"fleet has {n_models} local models (0 .. {n_models - 1})")
    if stream == "replay":
        tr = tuple(hm.conf_trace.shape)
        if len(tr) != 4 or tr[1] != n_devices or tr[3] != 3:
            raise ValueError(
                f"stream='replay' needs conf_trace shaped (periods, "
                f"{n_devices}, batch_max, 3); got {tr} "
                f"(presample_stream builds one)")
        if batch_max is not None and tr[2] != batch_max:
            raise ValueError(
                f"conf_trace replays {tr[2]} job slots per device "
                f"but the queue's batch_max is {batch_max}")
