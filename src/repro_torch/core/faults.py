"""Fault injection and the degradation ladder (port of
`repro.core.faults`).

The paper's AMR^2 guarantee (makespan <= 2T) assumes the plan executes as
priced.  This module injects the mid-period surprises the planner cannot
see — an ES crash after admission, link degradation, straggler EDs,
per-sample offload loss — and resolves every failed offload with a
deterministic ladder, as tensor work inside the engine's period:

1. **Retry** with capped exponential backoff: ``max_retries`` unrolled
   masked rounds.  Round ``k`` costs ``min(backoff_base * 2**(k-1),
   backoff_cap)`` plus the resend of every still-lost sample at the
   degraded link rate, and opens only while the device's realized ES
   time is under ``2T``, so that time never exceeds ``2T + backoff_cap +
   admitted_demand * link_factor``.  An ES crash skips the retries.
2. **Fall back locally**: the largest local model that still fits the
   residual ``max(0, 2T - realized ED time)``, in job order
   (`greedy_local_fill`).
3. **Drop**: accuracy 0, counted in ``n_dropped``; ``n_offload_samples ==
   n_offload_ok + n_fallback_local + n_dropped`` holds per period.

`FaultModel` holds Python floats: they are exact float64 scalars that
combine with tensors on any device without a copy, and ``is_null`` (which
decides whether the engine runs the ladder at all) needs no host read.

Random streams: `sample_realization` draws on the given device from
generators seeded by (fault_seed, period) — the port's counterpart of the
reference's ``fold_in(PRNGKey(fault_seed), period)``, which torch cannot
redraw.  It matches the reference in distribution; a parity run replays
the reference's draws through the engine's fault trace instead.  Every
per-device sum runs in slot order (`core.problem.slot_sum`), as the
engine's ES demand does, so under null faults the realized ES time equals
the priced demand bit for bit on the CPU and the card alike.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from .._device import DeviceLike, resolve_device, seeded_generator
from .problem import slot_sum

__all__ = [
    "FaultModel", "FaultRealization", "RealizedExecution",
    "sample_realization", "sample_trace", "greedy_local_fill",
    "realize_execution",
]


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Per-period fault distribution.

    ``es_crash_prob`` for the whole pool (one draw a period),
    ``link_degrade_prob`` / ``straggler_prob`` per device, ``loss_rate``
    per offloaded sample and attempt (a sample survives no attempt with
    probability ``loss_rate ** (max_retries + 1)``)."""

    es_crash_prob: float = 0.0      # P[ES pool crashes mid-period]
    link_degrade_prob: float = 0.0  # P[a device's link degrades]
    link_degrade_mag: float = 0.0   # max extra slowdown (factor 1+mag*U)
    straggler_prob: float = 0.0     # P[a device straggles this period]
    straggler_mult: float = 1.0     # ED slowdown factor when straggling
    loss_rate: float = 0.0          # P[an offload attempt is lost]
    backoff_base: float = 0.0       # first-retry backoff (seconds)
    backoff_cap: float = 0.0        # max per-round backoff (seconds)

    @classmethod
    def none(cls) -> "FaultModel":
        """The all-zero model: chaos disarmed, bitwise-invisible."""
        return cls()

    @classmethod
    def make(cls, *, es_crash_prob: float = 0.0,
             link_degrade_prob: float = 0.0, link_degrade_mag: float = 0.0,
             straggler_prob: float = 0.0, straggler_mult: float = 1.0,
             loss_rate: float = 0.0, backoff_base: float = 0.02,
             backoff_cap: float = 0.25) -> "FaultModel":
        """Keyword constructor with the reference's range checks."""
        for name, v, lo, hi in (
                ("es_crash_prob", es_crash_prob, 0.0, 1.0),
                ("link_degrade_prob", link_degrade_prob, 0.0, 1.0),
                ("straggler_prob", straggler_prob, 0.0, 1.0),
                ("loss_rate", loss_rate, 0.0, 1.0)):
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name}={v} must be in [{lo}, {hi}]")
        if link_degrade_mag < 0:
            raise ValueError("link_degrade_mag must be >= 0")
        if straggler_mult < 1.0:
            raise ValueError("straggler_mult must be >= 1 (a slowdown)")
        if backoff_base < 0 or backoff_cap < 0:
            raise ValueError("backoff_base/backoff_cap must be >= 0")
        return cls(es_crash_prob=float(es_crash_prob),
                   link_degrade_prob=float(link_degrade_prob),
                   link_degrade_mag=float(link_degrade_mag),
                   straggler_prob=float(straggler_prob),
                   straggler_mult=float(straggler_mult),
                   loss_rate=float(loss_rate),
                   backoff_base=float(backoff_base),
                   backoff_cap=float(backoff_cap))

    def is_null(self) -> bool:
        """No fault can ever fire under this model."""
        return (self.es_crash_prob == 0.0 and self.link_degrade_prob == 0.0
                and self.straggler_prob == 0.0 and self.loss_rate == 0.0)


FAULT_FIELDS = tuple(f.name for f in dataclasses.fields(FaultModel))


class FaultRealization(NamedTuple):
    """One period's concrete fault draw (or, with a leading period axis
    on every field, a replayed trace of them)."""

    es_crash: torch.Tensor          # ()   bool — pool down mid-period
    link_factor: torch.Tensor       # (D,) ES-transmission slowdown (>= 1)
    straggler_factor: torch.Tensor  # (D,) ED slowdown (>= 1)
    lost: torch.Tensor              # (D, n, A) per-attempt offload loss


class RealizedExecution(NamedTuple):
    """Realized walls, per-sample accuracy and ladder counters, per
    device."""

    acc: torch.Tensor               # (D, n) realized per-sample accuracy
    ed_wall: torch.Tensor           # (D,) realized ED time incl. fallback
    ed_audit: torch.Tensor          # (D,) realized ED time excl. fallback
    es_wall: torch.Tensor           # (D,) realized ES time incl. retries
    wall: torch.Tensor              # (D,) realized device makespan
    n_offload: torch.Tensor         # (D,) int32 admitted offloaded samples
    n_offload_ok: torch.Tensor      # (D,) int32 completed via ES
    n_retries: torch.Tensor         # (D,) int32 retry attempts
    n_fallback_local: torch.Tensor  # (D,) int32 rung-2 local completions
    n_dropped: torch.Tensor         # (D,) int32 rung-3 drops
    n_deadline_miss: torch.Tensor   # (D,) int32 samples past the 2T bound


def sample_realization(key: Tuple[int, int], fm: FaultModel, n_devices: int,
                       n_jobs: int, max_attempts: int, *,
                       device: DeviceLike = None) -> FaultRealization:
    """Draw one period's faults on ``device`` for ``key`` = (fault_seed,
    period): one shared crash draw, then per device a link, a magnitude
    and a straggler uniform (one (D, 3) draw) and (n_jobs, max_attempts)
    loss uniforms (one (D, n, A) draw), each from its own generator, so a
    device's draws depend only on the key and its index in the fleet.
    The same key gives the same draw; the stream is independent of the
    arrivals'."""
    dev = resolve_device(device)
    seed, period = (int(k) for k in key)
    f64 = dict(dtype=torch.float64, device=dev)
    u_crash = torch.rand((), generator=seeded_generator(seed, period, 2, dev),
                         **f64)
    u = torch.rand((n_devices, 3),
                   generator=seeded_generator(seed, period, 3, dev), **f64)
    u_loss = torch.rand((n_devices, n_jobs, max_attempts),
                        generator=seeded_generator(seed, period, 4, dev),
                        **f64)
    link = torch.where(u[:, 0] < fm.link_degrade_prob,
                       1.0 + fm.link_degrade_mag * u[:, 1], 1.0)
    strag = torch.where(u[:, 2] < fm.straggler_prob,
                        u.new_tensor(fm.straggler_mult), 1.0)
    return FaultRealization(es_crash=u_crash < fm.es_crash_prob,
                            link_factor=link, straggler_factor=strag,
                            lost=u_loss < fm.loss_rate)


def sample_trace(fault_seed: int, fm: FaultModel, n_devices: int,
                 n_jobs: int, max_attempts: int, periods: int, *,
                 device: DeviceLike = None) -> FaultRealization:
    """The draws of periods 0..periods-1 (`sample_realization` with key
    (fault_seed, t)) stacked on a leading period axis: a replayable
    ``fault_trace`` that another device can replay bit for bit."""
    draws = [sample_realization((fault_seed, t), fm, n_devices, n_jobs,
                                max_attempts, device=device)
             for t in range(periods)]
    return FaultRealization(*(torch.stack(x) for x in zip(*draws)))


def greedy_local_fill(lat_jobs, acc_local, budget, eligible):
    """For each eligible sample, in job order, pick the max-accuracy local
    model whose latency still fits the device's residual budget, and spend
    it.

    ``lat_jobs`` (D, n, m) per-sample local-model latencies, ``acc_local``
    (D, m) local accuracies, ``budget`` (D,) seconds, ``eligible`` (D, n)
    bool.  Returns ``(choice (D, n) int32 — model index, m = nothing fits
    —, fit (D, n) bool, time_used (D,))``.  Argmax ties break to the
    lowest model index.  The reference's ``lax.scan`` over jobs is a loop
    of n vectorized steps.  Used for rung 2 of the ladder and for
    recovering unsolved LP lanes."""
    D, n, m = lat_jobs.shape
    dev = lat_jobs.device
    res0 = torch.as_tensor(budget, dtype=torch.float64,
                           device=dev).expand(D)
    res = res0
    lanes = torch.arange(D, device=dev)
    choices, fits_out = [], []
    for s in range(n):
        lat_j, elig_j = lat_jobs[:, s], eligible[:, s]
        fits = lat_j <= res[:, None] + 1e-12
        score = torch.where(fits, acc_local, -torch.inf)
        pick = score.argmax(dim=1)
        take = elig_j & fits.any(dim=1)
        spend = torch.where(take, lat_j[lanes, pick], 0.0)
        choices.append(torch.where(take, pick, m).to(torch.int32))
        fits_out.append(take)
        res = res - spend
    return (torch.stack(choices, dim=1), torch.stack(fits_out, dim=1),
            res0 - res)


def realize_execution(fm: FaultModel, real: FaultRealization, *, mask,
                      es_samp, acc_jobs, p_es_jobs, ed_wall, lat_local, acc,
                      T, max_retries: int) -> RealizedExecution:
    """Replay the plan through one period's fault realization and walk the
    ladder for every failed offload.

    ``mask`` (D, n) real samples, ``es_samp`` (D, n) admitted offloads,
    ``acc_jobs`` (D, n) planned per-sample accuracies, ``p_es_jobs``
    (D, n) priced per-sample ES seconds, ``ed_wall`` (D,) the nominal
    realized ED time, ``lat_local`` (D, n, m) realized local-model
    latencies (base x drift x straggler), ``acc`` (D, m+1), ``T`` the
    period budget.  Identity factors and no losses reproduce the priced
    execution bit for bit (`x * 1.0` and `x + 0.0` are exact).  The retry
    rounds unroll over the static ``max_retries``; nothing here reads a
    value back to the host."""
    D, n, m = lat_local.shape
    i32 = torch.int32
    deadline = 2.0 * T                     # the paper's AMR^2 guarantee
    link = real.link_factor
    es_cost = torch.where(es_samp, p_es_jobs, 0.0)     # priced seconds
    es_time = slot_sum(es_cost) * link                 # first attempt
    failed = es_samp & (real.lost[:, :, 0] | real.es_crash)
    n_retries = torch.zeros(D, dtype=i32, device=lat_local.device)
    for k in range(1, max_retries + 1):
        backoff = min(fm.backoff_base * (2.0 ** (k - 1)), fm.backoff_cap)
        can = (~real.es_crash) & (es_time < deadline) & failed.any(dim=1)
        attempt = failed & can[:, None]
        resend = slot_sum(torch.where(attempt, es_cost, 0.0)) * link
        es_time = es_time + torch.where(can, backoff + resend, 0.0)
        n_retries = n_retries + attempt.sum(dim=1).to(i32)
        failed = torch.where(attempt, real.lost[:, :, k], failed)

    ed_real = ed_wall * real.straggler_factor
    residual = torch.clamp_min(deadline - ed_real, 0.0)
    choice, fit, fb_time = greedy_local_fill(lat_local, acc[:, :m],
                                             residual, failed)
    dropped = failed & ~fit
    ed_final = ed_real + fb_time
    ok_off = es_samp & ~failed

    rows = torch.arange(D, device=acc.device)[:, None]
    acc_real = torch.where(fit, acc[rows, choice.clamp(0, m - 1).long()],
                           acc_jobs)
    acc_real = torch.where(dropped, 0.0, acc_real)

    on_ed = mask & ~es_samp
    late_ed = (ed_final > deadline)[:, None]
    late_es = (es_time > deadline)[:, None]
    miss = dropped | ((on_ed | fit) & late_ed) | (ok_off & late_es)

    def count(b):
        return b.sum(dim=1).to(i32)

    return RealizedExecution(
        acc=acc_real, ed_wall=ed_final, ed_audit=ed_real, es_wall=es_time,
        wall=torch.maximum(ed_final, es_time),
        n_offload=count(es_samp), n_offload_ok=count(ok_off),
        n_retries=n_retries, n_fallback_local=count(fit),
        n_dropped=count(dropped), n_deadline_miss=count(miss))
