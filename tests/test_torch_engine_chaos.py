"""The chaos scenario on the port's tensor engine and its delegated
`FleetEngine`, against the reference.

* Armed-null invisibility inside the port: ``chaos=True`` with
  `FaultModel.none()` equals the chaos-off rollout bit for bit, every
  metric and every state field (the ES belief included).
* The rollout against the reference's with the reference's own fault
  draws replayed (`EngineParams.fault_trace`, filled by
  `test_torch_parity_util.reference_fault_draws` with the key the
  reference's step builds for period t): 16 devices, 10 periods, both LP
  methods, the reference bench's harsh model and a link-heavy one that
  fires the ES-latency audit.  Ladder counters, ``n_es_audit_updates`` and
  ``n_straggler_updates`` exact; floats, the final ``p_ed`` and
  ``p_es_belief`` to 1e-9.  Audits at threshold 1.4 (ROADMAP §3 item 1).
* The delegated `FleetEngine.run` equal bit for bit to `rollout` under
  chaos (the port's own draws, and a replayed trace), and its stats
  against the reference's `FleetEngine` under the same draws.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import engine as RE
from repro.core import faults as RF
from repro.serving import FleetConfig as RefConfig
from repro.serving import FleetEngine as RefEngine
from repro.serving.fleet import make_fleet as ref_make_fleet
from repro.serving.queue import RequestQueue as RefQueue
from repro_torch import convert
from repro_torch.api import engine as PE
from repro_torch.core.faults import FaultModel
from repro_torch.serving import FleetConfig, FleetEngine, FleetPeriodStats
from repro_torch.serving.fleet import make_fleet
from repro_torch.serving.queue import RequestQueue
from test_torch_parity_util import (reference_fault_draws, reference_x64,
                                    to_numpy)

V5E = dict(es_peak_flops=197e12, es_hbm_bw=819e9)
CLASSES = (128, 512, 1024)
D, PERIODS, SEED, N_JOBS = 16, 10, 3, 12
HARSH = dict(es_crash_prob=0.08, link_degrade_prob=0.25,
             link_degrade_mag=0.6, straggler_prob=0.2, straggler_mult=1.8,
             loss_rate=0.15)
HOT = dict(link_degrade_prob=0.6, link_degrade_mag=3.0, loss_rate=0.1)
SHARED_STATE = tuple(f for f in PE.STATE_FIELDS if f != "seed")
STATS = [f.name for f in dataclasses.fields(FleetPeriodStats)
         if f.name not in ("plan_seconds", "n_devices")]


def _port_params(lp_method, threshold=1.4, **kw):
    return PE.EngineParams.from_fleet(
        make_fleet(D, seed=SEED, horizon=PERIODS, **V5E),
        RequestQueue(D, CLASSES, rate=10.0, batch_max=N_JOBS, seed=SEED),
        T=1.2, n_servers=2, horizon=PERIODS, lp_method=lp_method,
        straggler_threshold=threshold, device="cpu", **kw)


def _assert_metrics(pm, rm):
    for f in PE.METRIC_FIELDS:
        a, b = to_numpy(getattr(pm, f)), np.asarray(getattr(rm, f))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_armed_null_is_bitwise_invisible(lp_method):
    """The realized-execution pass runs (``chaos=True``) under the null
    model and reproduces the chaos-off rollout bit for bit."""
    base = _port_params(lp_method, threshold=1.5)
    armed = dataclasses.replace(base, chaos=True)
    assert not base.chaos and armed.faults.is_null()
    s0, m0 = PE.rollout(PE.init_state(base, device="cpu"), base, PERIODS,
                        device="cpu")
    s1, m1 = PE.rollout(PE.init_state(armed, device="cpu"), armed, PERIODS,
                        device="cpu")
    for f in PE.METRIC_FIELDS:
        assert torch.equal(getattr(m0, f), getattr(m1, f)), f
    for f in PE.STATE_FIELDS:
        assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    assert torch.equal(s1.p_es_belief, base.p_es)
    assert int(m1.n_offload_samples.sum()) > 0
    # disarming through with_faults restores the flag and the model
    assert not armed.with_faults(None).chaos
    assert armed.with_faults(FaultModel.make(loss_rate=0.2)).chaos


@pytest.mark.parametrize("lp_method,model", [("tableau", "harsh"),
                                             ("revised", "harsh"),
                                             ("tableau", "hot"),
                                             ("revised", "hot")])
def test_chaos_rollout_matches_reference(lp_method, model):
    kw = {"harsh": HARSH, "hot": HOT}[model]
    ref_fm = RF.FaultModel.make(**kw)
    ref = RE.EngineParams.from_fleet(
        ref_make_fleet(D, seed=SEED, horizon=PERIODS),
        RefQueue(D, CLASSES, rate=10.0, batch_max=N_JOBS, seed=SEED),
        T=1.2, n_servers=2, horizon=PERIODS, lp_method=lp_method,
        straggler_threshold=1.4, faults=ref_fm, fault_seed=11,
        max_retries=2)
    draws = reference_fault_draws(ref_fm, 11, D, N_JOBS, 2, PERIODS)
    port = _port_params(lp_method, faults=convert.fault_model_from_numpy(
        ref_fm), fault_seed=11, max_retries=2,
        fault_trace=convert.fault_trace_from_numpy(draws, "cpu"))
    assert port.chaos and ref.chaos
    with reference_x64():
        rs, rm = RE.rollout(RE.init_state(ref), ref, PERIODS)
    ps, pm = PE.rollout(PE.init_state(port, device="cpu"), port, PERIODS,
                        device="cpu")
    _assert_metrics(pm, rm)
    # the carried bases are not compared across packages: a degenerate
    # LP's optimal basis may differ in its labels (ROADMAP §3 item 2)
    for f in SHARED_STATE:
        a, b = to_numpy(getattr(ps, f)), np.asarray(getattr(rs, f))
        if f == "warm_basis":
            continue
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    n_off = to_numpy(pm.n_offload_samples)
    np.testing.assert_array_equal(
        n_off, to_numpy(pm.n_offload_ok) + to_numpy(pm.n_fallback_local)
        + to_numpy(pm.n_dropped))
    fired = sum(int(to_numpy(getattr(pm, f)).sum())
                for f in ("n_retries", "n_fallback_local", "n_dropped"))
    assert fired > 0 and int(to_numpy(pm.n_es_audit_updates).sum()) > 0
    if model == "hot":
        assert (to_numpy(ps.p_es_belief) > to_numpy(port.p_es)).any()


def _config(**kw):
    base = dict(n_devices=8, T=1.2, n_servers=2, policy="amr2", rate=9.0,
                batch_max=8, horizon=12, seed=5, straggler_threshold=1.4,
                faults=None, fault_seed=4, max_retries=2)
    base.update(kw)
    return base


@pytest.mark.parametrize("lp_method,replayed", [("tableau", False),
                                                ("revised", True)])
def test_delegated_run_equals_rollout_under_chaos(lp_method, replayed):
    """`FleetEngine.run(P)` threads the ES belief and each period's
    realization as `rollout` does: bit for bit, the port's own draws or a
    replayed trace."""
    periods = 10
    fm = FaultModel.make(**HARSH)
    trace = None
    if replayed:
        trace = convert.fault_trace_from_numpy(reference_fault_draws(
            RF.FaultModel.make(**HARSH), 4, 8, 8, 2, periods), "cpu")
    cfg = FleetConfig(**V5E, **_config(faults=fm, fault_trace=trace,
                                       lp_method=lp_method))
    eng = FleetEngine.from_config(cfg, device="cpu")
    assert eng._v2_params.chaos
    params = PE.EngineParams.from_config(cfg, horizon=periods + 2,
                                         device="cpu")
    state, metrics = PE.rollout(PE.init_state(params, device="cpu"), params,
                                periods, device="cpu")
    stats = eng.run(periods)
    for i, s in enumerate(stats):
        for f in STATS:
            assert getattr(metrics, f)[i].item() == getattr(s, f), (i, f)
    assert torch.equal(eng._v2_es_belief, state.p_es_belief)
    beliefs = np.stack([d.profile.p_ed for d in eng.devices])
    np.testing.assert_array_equal(state.p_ed.numpy(),
                                  beliefs[:, eng._v2_lut, :])
    assert int(metrics.n_fallback_local.sum()) \
        + int(metrics.n_dropped.sum()) > 0


def test_delegated_run_matches_the_reference_fleet_engine():
    """The port's `FleetEngine` replaying the reference's draws against
    the reference's `FleetEngine` (which draws them itself)."""
    periods = 10
    kw = _config()
    ref_fm = RF.FaultModel.make(**HARSH)
    ref = RefEngine.from_config(RefConfig(backend="jax",
                                          **{**kw, "faults": ref_fm}))
    trace = convert.fault_trace_from_numpy(reference_fault_draws(
        ref_fm, kw["fault_seed"], kw["n_devices"], kw["batch_max"],
        kw["max_retries"], periods), "cpu")
    port = FleetEngine.from_config(FleetConfig(
        **V5E, **{**kw, "faults": convert.fault_model_from_numpy(ref_fm),
                  "fault_trace": trace}), device="cpu")
    with reference_x64():
        want = ref.run(periods)
    got = port.run(periods)
    for w, g in zip(want, got):
        for f in STATS:
            a, b = getattr(w, f), getattr(g, f)
            if isinstance(a, float):
                assert abs(a - b) <= 1e-9, (w.period, f, a, b)
            else:
                assert a == b, (w.period, f, a, b)
    np.testing.assert_allclose(to_numpy(port._v2_es_belief),
                               np.asarray(ref._v2_es_belief), atol=1e-9,
                               rtol=0)
    assert sum(s.n_retries for s in got) > 0


def test_from_config_carries_chaos_and_trace_shapes_are_checked():
    fm = FaultModel.make(loss_rate=0.3)
    cfg = FleetConfig(**V5E, **_config(faults=fm, max_retries=3,
                                       fault_seed=9))
    params = PE.EngineParams.from_config(cfg, device="cpu")
    assert (params.chaos, params.max_retries, params.fault_seed) \
        == (True, 3, 9) and params.faults == fm
    real = PE._realization(params, 2)
    assert tuple(real.lost.shape) == (8, 8, 4)
    bad = PE._realization(params, 0)._replace(
        lost=torch.zeros((8, 8, 2), dtype=torch.bool))
    trace = type(bad)(*(x[None] for x in bad))
    with pytest.raises(ValueError, match="fault_trace.lost"):
        params.with_faults(fm, fault_trace=trace)
    with pytest.raises(ValueError, match="max_retries"):
        params.with_faults(fm, max_retries=-1)
