"""`FleetEngine`'s delegation to the tensor engine, `FleetConfig` and
`run_period_reference`, on the CPU.

Inside the port, bit for bit (the reference's own pin,
`tests/test_engine_v2.py`): `FleetEngine.from_config(cfg).run(P)` equals
`rollout` of `EngineParams.from_config(cfg)` — every `FleetPeriodStats`
field against the stacked metrics, the warm bases and the beliefs — for
amr2 (36 periods, both LP methods) and dual (6 periods), with
backpressure and straggler updates present.  Against the reference, with
the same fleet (the reference's TPU v5e ES constants passed explicitly):
the delegated runs and `run_period_reference` (the NumPy backend, no
stragglers), integers exact and floats to 1e-9.  The cross-package
delegated runs audit at threshold 1.4, off the tie at 1.5 (ROADMAP §3
item 1).
"""
import dataclasses

import numpy as np
import pytest

from repro.serving import FleetConfig as RefConfig
from repro.serving import FleetEngine as RefEngine
from repro_torch.api import engine as E
from repro_torch.core.hi import HIModel
from repro_torch.core.mobility import MobilityModel
from repro_torch.core.problem import ST_UNSOLVED
from repro_torch.serving import (DeviceSpec, FleetConfig, FleetEngine,
                                 FleetPeriodStats, RequestQueue, TierProfile,
                                 UnsolvedPeriodError)
from test_torch_parity_util import reference_x64

V5E = dict(es_peak_flops=197e12, es_hbm_bw=819e9)
STATS = [f.name for f in dataclasses.fields(FleetPeriodStats)
         if f.name not in ("plan_seconds", "n_devices")]


def _config(n_devices=8, *, policy="amr2", seed=0, horizon=40, rate=9.0,
            n_servers=2, straggler_frac=0.25, outage_frac=0.1, batch_max=8,
            **kw):
    return dict(n_devices=n_devices, T=1.2, n_servers=n_servers,
                policy=policy, rate=rate, batch_max=batch_max,
                horizon=horizon, seed=seed, straggler_frac=straggler_frac,
                outage_frac=outage_frac, **kw)


def _port_config(**kw):
    return FleetConfig(**V5E, **_config(**kw))


def _assert_run_equals_rollout(cfg, periods):
    eng = FleetEngine.from_config(cfg, device="cpu")
    assert eng._v2_params is not None           # delegation active
    params = E.EngineParams.from_config(cfg, horizon=periods + 2,
                                        device="cpu")
    state, metrics = E.rollout(E.init_state(params, device="cpu"), params,
                               periods, device="cpu")
    stats = eng.run(periods)
    for i, s in enumerate(stats):
        for f in STATS:
            assert getattr(metrics, f)[i].item() == getattr(s, f), (i, f)
    beliefs = np.stack([d.profile.p_ed for d in eng.devices])
    np.testing.assert_array_equal(state.p_ed.numpy(),
                                  beliefs[:, eng._v2_lut, :])
    np.testing.assert_array_equal(
        state.n_updates.numpy(), [d.n_updates for d in eng.devices])
    assert int(metrics.n_backpressured.sum()) > 0
    assert int(metrics.n_straggler_updates.sum()) > 0
    return state, eng


@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_amr2_run_equals_rollout_bit_for_bit_36_periods(lp_method):
    cfg = _port_config(seed=0, horizon=38, lp_method=lp_method)
    state, eng = _assert_run_equals_rollout(cfg, 36)
    np.testing.assert_array_equal(state.warm_basis.numpy(),
                                  eng._groups[0].warm_basis)


@pytest.mark.parametrize("seed", [0, 4])
def test_dual_run_equals_rollout_bit_for_bit(seed):
    cfg = _port_config(policy="dual", seed=seed, horizon=8)
    state, eng = _assert_run_equals_rollout(cfg, 6)
    # the dual carries no basis: the rollout's stays cold, the engine's
    # is never set
    assert (state.warm_basis == -1).all()
    assert eng._groups[0].warm_basis is None


@pytest.mark.parametrize("seed", [2, 9])
def test_unsorted_queue_classes_price_as_the_host_pipeline(seed):
    """An unsorted queue class table: the delegated period maps arrival
    values to class indices through the argsort-indirected searchsorted,
    and prices as the host pipeline does."""
    prof = TierProfile(name="t", p_ed=np.array([[0.02, 0.08],
                                                [0.01, 0.04]]),
                       p_es=np.array([0.5, 0.35]),
                       acc=np.array([0.4, 0.56, 0.77]), classes=[64, 512])

    def build(delegate):
        q = RequestQueue(3, (512, 64), rate=6.0, batch_max=5, seed=seed)
        return FleetEngine([DeviceSpec(profile=prof) for _ in range(3)], q,
                           n_servers=1, T=0.5, policy="amr2",
                           delegate=delegate, device="cpu")

    v2, host = build(True), build(False)
    assert v2._v2_params is not None and host._v2_params is None
    for period in range(4):
        sv, sh = v2.run_period(), host.run_period()
        assert sv.n_jobs == sh.n_jobs and sv.backlog == sh.backlog
        assert sv.total_accuracy == pytest.approx(sh.total_accuracy,
                                                  abs=1e-9), period


@pytest.mark.parametrize("strict", ["raise", "warn"])
def test_unsolved_period_raises_with_partial_stats_or_warns(strict):
    cfg = _port_config(n_devices=4, horizon=4, straggler_frac=0.0,
                       outage_frac=0.0, strict=strict)
    eng = FleetEngine.from_config(cfg, device="cpu")
    first = eng.run_period()                    # a normal period first
    eng._v2_params = dataclasses.replace(eng._v2_params, maxiter=1)
    if strict == "raise":
        with pytest.raises(UnsolvedPeriodError,
                           match="not solved to optimality") as err:
            eng.run_period()
        assert err.value.period == 1 and err.value.n_unsolved > 0
        assert err.value.partial_stats == [first] == eng.history
    else:
        with pytest.warns(RuntimeWarning, match="not solved"):
            stats = eng.run_period()
        assert eng.history == [first, stats] and stats.n_jobs > 0
    # the rollout books the same lanes as unsolved instead of raising
    params = dataclasses.replace(
        E.EngineParams.from_config(cfg, horizon=4, device="cpu"), maxiter=1)
    _, m = E.rollout(E.init_state(params, device="cpu"), params, 2,
                     device="cpu")
    assert int(m.n_unsolved.sum()) > 0 and ST_UNSOLVED == 4
    with pytest.raises(ValueError, match="strict"):
        FleetEngine.from_config(dataclasses.replace(cfg, strict="ignore"),
                                device="cpu")


def _compare_stats(want, got, n_devices):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.n_devices == w.n_devices == n_devices
        for f in STATS:
            a, b = getattr(w, f), getattr(g, f)
            if isinstance(a, float):
                assert abs(a - b) <= 1e-9, (w.period, f, a, b)
            else:
                assert a == b, (w.period, f, a, b)


@pytest.mark.parametrize("policy,seed,periods",
                         [("amr2", 0, 12), ("amr2", 5, 12), ("dual", 1, 8)])
def test_delegated_run_matches_the_reference(policy, seed, periods):
    kw = _config(policy=policy, seed=seed, horizon=periods,
                 straggler_threshold=1.4)
    ref = RefEngine.from_config(RefConfig(backend="jax", **kw))
    port = FleetEngine.from_config(FleetConfig(**V5E, **kw), device="cpu")
    assert ref._v2_params is not None and port._v2_params is not None
    with reference_x64():
        want = ref.run(periods)
    got = port.run(periods)
    _compare_stats(want, got, kw["n_devices"])
    for dr, dp in zip(ref.devices, port.devices):
        assert dp.n_updates == dr.n_updates
        np.testing.assert_allclose(dp.profile.p_ed, dr.profile.p_ed,
                                   rtol=0, atol=1e-9)
    # (the carried bases are not compared across packages: a degenerate
    # LP's optimal basis may differ in its labels, ROADMAP §3 item 2; the
    # plans above agree)
    assert sum(s.n_backpressured for s in got) > 0


@pytest.mark.parametrize("seed", [5, 6])
def test_run_period_reference_matches_the_reference(seed):
    """The per-device loop on the NumPy backend (the reference's
    `test_rollout_matches_reference_loop` configuration), both packages
    solving with their NumPy oracles."""
    periods = 5
    kw = _config(6, policy="amr2", seed=seed, horizon=periods + 2,
                 straggler_frac=0.0)
    ref = RefEngine.from_config(RefConfig(backend="numpy", **kw))
    port = FleetEngine.from_config(FleetConfig(backend="numpy", **V5E, **kw),
                                   device="cpu")
    assert port._v2_params is None             # the NumPy backend
    want = [ref.run_period_reference() for _ in range(periods)]
    got = [port.run_period_reference() for _ in range(periods)]
    _compare_stats(want, got, 6)
    assert sum(s.n_jobs for s in got) > 0


def test_backend_and_config_guards():
    cfg = _port_config(n_devices=4, horizon=4)
    with pytest.raises(ValueError, match="'torch'"):
        FleetEngine.from_config(dataclasses.replace(cfg, backend="jax"),
                                device="cpu")
    mob = MobilityModel.make(cell_xy=np.zeros((1, 2)),
                             trace=np.zeros((4, 4, 2)))
    with pytest.raises(ValueError, match="pure-functional engine"):
        FleetEngine.from_config(dataclasses.replace(cfg, mobility=mob),
                                device="cpu")
    with pytest.raises(ValueError, match="max_retries"):
        E.EngineParams.from_config(dataclasses.replace(cfg, max_retries=-1),
                                   device="cpu")
    hi = E.EngineParams.from_config(
        dataclasses.replace(cfg, hi=HIModel.make(), hi_rule="exp3",
                            hi_arms=4, hi_seed=2), device="cpu")
    assert (hi.hi_rule, hi.hi_arms, hi.hi_seed) == ("exp3", 4, 2)
    with pytest.raises(ValueError, match="local model"):
        E.EngineParams.from_config(
            dataclasses.replace(cfg, hi=HIModel.make(), hi_local=5),
            device="cpu")
    with pytest.raises(TypeError):
        FleetConfig(n_devices=4, T=1.2)           # no ES rates, no default
    host = FleetEngine.from_config(dataclasses.replace(cfg, delegate=False),
                                   device="cpu")
    numpy = FleetEngine.from_config(dataclasses.replace(cfg,
                                                        backend="numpy"),
                                    device="cpu")
    assert host._v2_params is None and numpy._v2_params is None
    a, b = host.run(2), numpy.run(2)
    assert [s.n_jobs for s in a] == [s.n_jobs for s in b]
