"""The tensor engine's Poisson arrivals (``arrivals="poisson"``), on the
CPU.  jax's threefry draws cannot be redrawn in torch, so the mode is
held to its distribution, not to the reference draw for draw:

* jobs are conserved: released plus backlog equals drawn;
* counts per device-period average ``rate`` and classes follow
  ``class_probs``, each within 5 standard errors;
* rate 0 gives no jobs and no backlog; no device releases more than
  ``batch_max`` jobs a period;
* seeds 0 and 1 differ and a seed repeats bit for bit;
* `EngineParams.from_config` equals `from_fleet` on the same fleet.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import engine as PE
from repro_torch.serving.fleet import FleetConfig
from repro_torch.serving.queue import RequestQueue

V5E = dict(es_peak_flops=197e12, es_hbm_bw=819e9)
PROBS = (0.2, 0.5, 0.3)


def _config(D=6, rate=6.0, batch_max=8, seed=5, **kw):
    return FleetConfig(n_devices=D, T=1.2, n_servers=2, policy="amr2",
                       rate=rate, batch_max=batch_max, horizon=4, seed=seed,
                       straggler_frac=0.0, class_probs=PROBS, **V5E, **kw)


def _params(cfg):
    return PE.EngineParams.from_config(cfg, horizon=4, arrivals="poisson",
                                       device="cpu")


def _drawn(params, seed, t):
    """The counts the engine draws in period ``t`` (its own generator)."""
    return torch.poisson(params.rate, generator=PE._generator(
        seed, t, 0, params.device)).to(torch.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_rollout_conserves_jobs(seed):
    params = _params(_config())
    P = 10
    state, m = PE.rollout(PE.init_state(params, seed=seed, device="cpu"),
                          params, P, device="cpu")
    drawn = torch.stack([_drawn(params, seed, t) for t in range(P)])
    released = m.n_jobs.to(torch.int64)
    # period by period: backlog_t = backlog_{t-1} + drawn_t - released_t
    backlog = torch.cumsum(drawn.sum(1) - released, 0)
    assert torch.equal(backlog, m.backlog.to(torch.int64))
    assert int(released.sum()) + int(state.pending.sum()) == \
        int(drawn.sum())
    assert int(released.sum()) > 0 and int(m.n_unsolved.sum()) == 0
    assert (state.head == 0).all()          # no trace cursor moves


def test_no_device_releases_more_than_batch_max():
    params = _params(_config(rate=14.0, batch_max=4))
    state = PE.init_state(params, seed=3, device="cpu")
    for t in range(6):
        ci, take, pending, head = PE._arrivals(state, params, t)
        assert int(take.max()) <= params.batch_max
        assert ci.shape == (params.n_devices, params.batch_max)
        state = PE.EngineState(**{**{f: getattr(state, f)
                                     for f in PE.STATE_FIELDS},
                                  "pending": pending})
    assert int(state.pending.sum()) > 0       # rate 14 outruns 4 a period
    _, m = PE.rollout(PE.init_state(params, seed=3, device="cpu"), params,
                      3, device="cpu")
    assert int(m.n_jobs.max()) <= params.n_devices * params.batch_max


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rate", [0.7, 6.0])
def test_counts_and_classes_follow_their_distributions(seed, rate):
    """Straight from `_arrivals`: 512 devices x 24 periods of counts, and
    every release slot's class."""
    D, P, n = 512, 24, 8
    q = RequestQueue(D, (128, 512, 1024), rate=rate, batch_max=n, seed=0,
                     class_probs=PROBS)
    cfg = _config(D=D, rate=rate, batch_max=n)
    params = PE.EngineParams.from_fleet(cfg.build_devices(), q, T=1.2,
                                        arrivals="poisson", horizon=1,
                                        device="cpu")
    state = PE.init_state(params, seed=seed, device="cpu")
    counts, classes = [], []
    for t in range(P):
        counts.append(_drawn(params, seed, t))
        ci, take, _pending, _head = PE._arrivals(state, params, t)
        # from an empty backlog the release is the draw, capped at n
        assert torch.equal(take.to(torch.int64),
                           counts[-1].clamp_max(n))
        classes.append(ci.reshape(-1))
    counts = torch.stack(counts).double()
    N = counts.numel()
    assert abs(counts.mean().item() - rate) <= 5 * np.sqrt(rate / N)
    classes = torch.cat(classes)
    freq = torch.bincount(classes, minlength=3).double() / classes.numel()
    for k, p in enumerate(PROBS):
        se = np.sqrt(p * (1 - p) / classes.numel())
        assert abs(freq[k].item() - p) <= 5 * se, (k, freq.tolist())


def test_zero_rate_gives_no_jobs_and_no_backlog():
    params = _params(_config(rate=0.0))
    _, m = PE.rollout(PE.init_state(params, device="cpu"), params, 6,
                      device="cpu")
    assert int(m.n_jobs.sum()) == 0 and int(m.backlog.sum()) == 0
    assert float(m.total_accuracy.sum()) == 0.0


def test_seeds_differ_and_a_seed_repeats_bit_for_bit():
    params = _params(_config())
    runs = {}
    for key, seed in (("a", 0), ("b", 0), ("c", 1)):
        runs[key] = PE.rollout(PE.init_state(params, seed=seed,
                                             device="cpu"),
                               params, 6, device="cpu")
    (sa, ma), (sb, mb), (_sc, mc) = runs["a"], runs["b"], runs["c"]
    for f in PE.METRIC_FIELDS:
        assert torch.equal(getattr(ma, f), getattr(mb, f)), f
    for f in PE.STATE_FIELDS:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert not torch.equal(ma.n_jobs, mc.n_jobs)
    with pytest.raises(ValueError, match="seed"):
        PE.init_state(params, seed=-1, device="cpu")


@pytest.mark.parametrize("arrivals", ["poisson", "replay"])
def test_from_config_equals_from_fleet(arrivals):
    cfg = _config()
    a = PE.EngineParams.from_config(cfg, horizon=4, arrivals=arrivals,
                                    device="cpu")
    b = PE.EngineParams.from_fleet(
        cfg.build_devices(), cfg.build_queue(), T=cfg.T,
        n_servers=cfg.n_servers, policy=cfg.policy, horizon=4,
        arrivals=arrivals, straggler_threshold=cfg.straggler_threshold,
        ema=cfg.ema, device="cpu")
    for f in PE.PARAM_ARRAYS:
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in PE.PARAM_CONFIG:
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_allclose(a.class_probs.numpy(), PROBS)
    assert (a.rate == 6.0).all() and a.arrivals == arrivals
    # the replay trace is presampled only in replay mode
    assert a.counts.shape[0] == (4 if arrivals == "replay" else 1)
