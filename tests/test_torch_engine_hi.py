"""Online hierarchical inference on the port's tensor engine, its
delegated `FleetEngine` and the front door, against the reference.

* Rollout parity for each rule under the reference's replayed streams:
  its `presample_stream` as ``conf_trace`` (``hi_stream="replay"``) and,
  for EXP3, its arm uniforms as the port-only ``hi_arm_trace``; params
  carried across by `convert.params_from_numpy`.  Integer metrics exact,
  floats, the beliefs and ``state.hi`` to 1e-9.  Audits at threshold 1.4
  (ROADMAP §3 item 1).
* The reference's `tests/test_hi.py` gates on the port's own draws: the
  accounting identity, zero clairvoyant regret, sublinear learning,
  beating the miscalibrated fixed rule, bandits on the grid; the
  disarmed round trip bit for bit the plain rollout, arrivals untouched,
  replay == fold; the mutual-exclusion guards.
* The delegated `FleetEngine.run` bit for bit `rollout`, and against the
  reference's run under the same replayed stream.
* ``hi_threshold`` / ``hi_bandit`` against the reference's entries.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as RAPI
from repro.api import engine as RE
from repro.core import hi as RH
from repro.serving import FleetConfig as RefConfig
from repro.serving import FleetEngine as RefEngine
from repro_torch import api as PAPI
from repro_torch import convert
from repro_torch.api import engine as PE
from repro_torch.core.faults import FaultModel
from repro_torch.core.hi import (HILearnerState, HIModel, HI_STATE_FIELDS,
                                 arm_grid, presample_stream)
from repro_torch.core.mobility import MobilityModel
from repro_torch.serving import FleetConfig, FleetEngine, FleetPeriodStats
from test_torch_parity_util import (reference_arm_uniforms, reference_x64,
                                    to_numpy)

V5E = dict(es_peak_flops=197e12, es_hbm_bw=819e9)
CPU = "cpu"
D, N_JOBS, PERIODS, HI_SEED = 8, 8, 10, 4
SHARED_STATE = tuple(f for f in PE.STATE_FIELDS if f != "seed")
STATS = [f.name for f in dataclasses.fields(FleetPeriodStats)
         if f.name not in ("plan_seconds", "n_devices")]


def _kw(horizon, threshold=1.4, **extra):
    return dict(n_devices=D, T=1.2, n_servers=2, policy="amr2", rate=9.0,
                batch_max=N_JOBS, horizon=horizon, seed=5,
                straggler_frac=0.25, outage_frac=0.1,
                straggler_threshold=threshold, **extra)


def _port(horizon=PERIODS + 2, **extra):
    return PE.EngineParams.from_config(FleetConfig(**V5E, **_kw(horizon,
                                                                **extra)),
                                       horizon=horizon, device=CPU)


def _rollout(params, periods):
    return PE.rollout(PE.init_state(params, device=CPU), params, periods,
                      device=CPU)


def _theta_star(params):
    return (params.acc[:, params.m] - params.hi.offload_cost).clamp(0, 1)


def _assert_state_hi(got, want):
    for f in HI_STATE_FIELDS:
        a, b = to_numpy(getattr(got, f)), np.asarray(getattr(want, f))
        if f == "arm":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("rule", ["fixed", "threshold", "ucb", "exp3"])
def test_rollout_matches_reference_under_replay(rule):
    with reference_x64():
        trace = RH.presample_stream(HI_SEED, D, N_JOBS, PERIODS)
    arms = np.stack([reference_arm_uniforms(HI_SEED, t, D)
                     for t in range(PERIODS)])
    ref = RE.EngineParams.from_config(
        RefConfig(backend="jax", **_kw(PERIODS)), horizon=PERIODS).with_hi(
            RH.HIModel.make(spread=[0.4, 0.6, 0.9], conf_trace=trace),
            rule=rule, stream="replay", n_arms=5, hi_seed=HI_SEED)
    fields = {f: getattr(ref, f) for f in RE._PARAM_LEAVES + RE._PARAM_AUX
              if f not in ("faults", "mobility")}
    port = convert.params_from_numpy({**fields, "hi_arm_trace": arms}, CPU)
    assert (port.hi_rule, port.hi_stream, port.hi_arms) == (rule, "replay",
                                                            5)
    with reference_x64():
        rs, rm = RE.rollout(RE.init_state(ref), ref, PERIODS)
    ps, pm = _rollout(port, PERIODS)
    for f in PE.METRIC_FIELDS:
        a, b = to_numpy(getattr(pm, f)), np.asarray(getattr(rm, f))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in SHARED_STATE:
        np.testing.assert_allclose(to_numpy(getattr(ps, f)),
                                   np.asarray(getattr(rs, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    _assert_state_hi(ps.hi, jax.tree.map(np.asarray, rs.hi))
    assert int(pm.n_hi_offloaded.sum()) > 0
    assert int(pm.n_hi_local_final.sum()) > 0


@pytest.mark.parametrize("rule", ["fixed", "threshold", "ucb", "exp3"])
def test_accounting_identity_every_period(rule):
    armed = _port().with_hi(HIModel.make(), rule=rule)
    _s, m = _rollout(armed, PERIODS)
    assert torch.equal(m.n_hi_offloaded + m.n_hi_local_final, m.n_jobs)
    reg = m.hi_regret
    assert float(reg.min()) >= 0.0
    assert bool((reg[1:] - reg[:-1] >= -1e-12).all())


def test_clairvoyant_fixed_threshold_has_zero_regret():
    params = _port(14)
    beta = 0.15
    theta_star = (params.acc[:, params.m] - beta).clamp(0.0, 1.0)
    armed = params.with_hi(HIModel.make(theta0=theta_star,
                                        offload_cost=beta), rule="fixed")
    _s, m = _rollout(armed, 12)
    assert float(m.hi_regret[-1]) == 0.0


@pytest.mark.parametrize("hi_seed", [0, 17])
def test_threshold_learner_converges_sublinearly(hi_seed):
    periods = 48
    armed = _port(periods + 2).with_hi(HIModel.make(), hi_seed=hi_seed)
    state, m = _rollout(armed, periods)
    err = (state.hi.theta - _theta_star(armed)).abs()
    assert float(err.mean()) < 0.1
    reg = m.hi_regret
    first = reg[periods // 2 - 1] - reg[0]
    second = reg[-1] - reg[periods // 2 - 1]
    assert float(second) < float(first)


def test_threshold_learner_beats_miscalibrated_fixed():
    periods = 32
    params = _port(periods + 2)
    _s, mf = _rollout(params.with_hi(HIModel.make(), rule="fixed"), periods)
    _s, ml = _rollout(params.with_hi(HIModel.make(), rule="threshold"),
                      periods)
    assert float(ml.hi_regret[-1]) < float(mf.hi_regret[-1])


@pytest.mark.parametrize("rule", ["ucb", "exp3"])
def test_bandit_rules_stay_on_the_grid(rule):
    periods = 16
    armed = _port(periods + 2).with_hi(HIModel.make(), rule=rule, n_arms=5)
    state, m = _rollout(armed, periods)
    cnt = state.hi.arms_cnt
    assert tuple(cnt.shape) == (D, 5)
    np.testing.assert_allclose(to_numpy(cnt.sum(dim=1)), periods)
    grid = torch.cat([arm_grid(5), torch.tensor([0.5], dtype=torch.float64)])
    assert bool((state.hi.theta[:, None] == grid[None]).any(dim=1).all())
    assert float(m.hi_regret[-1]) > 0.0


def test_disarmed_round_trip_is_bitwise_and_arrivals_untouched():
    params = _port()
    plain_s, plain_m = _rollout(params, PERIODS)
    off = params.with_hi(HIModel.make(), rule="exp3").with_hi(None)
    assert not off.hi_armed and off.hi.is_null()
    s, m = _rollout(off, PERIODS)
    for f in PE.METRIC_FIELDS:
        assert torch.equal(getattr(m, f), getattr(plain_m, f)), f
    for f in PE.STATE_FIELDS:
        assert torch.equal(getattr(s, f), getattr(plain_s, f)), f
    for f in ("n_hi_offloaded", "n_hi_local_final", "hi_regret"):
        assert float(getattr(m, f).abs().sum()) == 0.0, f
    armed = params.with_hi(HIModel.make(), hi_seed=3)
    s3, m3 = _rollout(armed, PERIODS)
    assert torch.equal(s3.head, plain_s.head)
    assert torch.equal(m3.n_jobs, plain_m.n_jobs)
    _s, m4 = _rollout(params.with_hi(HIModel.make(), hi_seed=4), PERIODS)
    assert not torch.equal(m3.hi_regret, m4.hi_regret)


@pytest.mark.parametrize("rule", ["threshold", "exp3"])
def test_replay_stream_equals_fold_stream(rule):
    params = _port()
    fold = params.with_hi(HIModel.make(), rule=rule, hi_seed=5)
    tr = presample_stream(5, D, N_JOBS, PERIODS + 2, device=CPU)
    replay = params.with_hi(HIModel.make(conf_trace=tr), rule=rule,
                            stream="replay", hi_seed=5)
    sf, mf = _rollout(fold, PERIODS)
    sr, mr = _rollout(replay, PERIODS)
    for f in PE.METRIC_FIELDS:
        assert torch.equal(getattr(mf, f), getattr(mr, f)), f
    for f in HI_STATE_FIELDS:
        assert torch.equal(getattr(sf.hi, f), getattr(sr.hi, f)), f


def test_hi_and_other_scenarios_are_mutually_exclusive():
    params = _port()
    armed = params.with_hi(HIModel.make())
    fm = FaultModel.make(es_crash_prob=0.1)
    mob = MobilityModel.make(cell_xy=np.zeros((1, 2)),
                             trace=np.zeros((8, D, 2)))
    with pytest.raises(ValueError, match="chaos disarmed"):
        params.with_faults(fm, fault_seed=1).with_hi(HIModel.make())
    with pytest.raises(ValueError, match="mobility off"):
        params.with_mobility(mob).with_hi(HIModel.make())
    with pytest.raises(ValueError, match="differentiable"):
        params.with_differentiable().with_hi(HIModel.make())
    for arm in (lambda: armed.with_faults(fm, fault_seed=1),
                lambda: armed.with_mobility(mob),
                lambda: armed.with_differentiable()):
        with pytest.raises(ValueError, match="HI disarmed"):
            arm()
    with pytest.raises(ValueError, match="local model"):
        params.with_hi(HIModel.make(), local_model=params.m)
    with pytest.raises(ValueError, match="hi_arm_trace"):
        params.with_hi(HIModel.make(), rule="exp3",
                       hi_arm_trace=np.zeros((3, D + 1)))
    state = PE.init_state(armed, device=CPU)
    with pytest.raises(ValueError, match="no learner"):
        PE.step(dataclasses.replace(state, hi=None), armed, device=CPU)
    for call in (lambda: PE.shard(state, armed, None),
                 lambda: PE.step_sharded(state, armed, None),
                 lambda: PE.rollout_sharded(state, armed, 2, None)):
        with pytest.raises(ValueError, match="sharded entry points do not "
                                             "support armed HI"):
            call()


def test_delegated_run_equals_rollout_and_the_reference():
    periods = 12
    tr_ref = None
    with reference_x64():
        tr_ref = RH.presample_stream(2, D, N_JOBS, periods)
    cfg = FleetConfig(**V5E, **_kw(40, hi=HIModel.make(conf_trace=tr_ref),
                                   hi_rule="threshold", hi_stream="replay",
                                   hi_seed=2))
    eng = FleetEngine.from_config(cfg, device=CPU)
    assert eng._v2_params is not None and eng._v2_params.hi_armed
    params = PE.EngineParams.from_config(cfg, horizon=40, device=CPU)
    state, m = _rollout(params, periods)
    stats = eng.run(periods)
    for i, st in enumerate(stats):
        for f in ("n_hi_offloaded", "n_hi_local_final", "hi_regret",
                  "total_accuracy", "n_jobs", "n_backpressured"):
            assert getattr(st, f) == getattr(m, f)[i].item(), (i, f)
    for f in HI_STATE_FIELDS:
        assert torch.equal(getattr(state.hi, f),
                           getattr(eng._v2_hi_state, f)), f
    ref = RefEngine.from_config(RefConfig(
        backend="jax", **_kw(40, hi=RH.HIModel.make(conf_trace=tr_ref),
                             hi_rule="threshold", hi_stream="replay",
                             hi_seed=2)))
    with reference_x64():
        want = ref.run(periods)
    for w, g in zip(want, stats):
        for f in STATS:
            a, b = getattr(g, f), getattr(w, f)
            if isinstance(b, float):
                assert abs(a - b) <= 1e-9, (w.period, f, a, b)
            else:
                assert a == b, (w.period, f, a, b)
    _assert_state_hi(eng._v2_hi_state,
                     jax.tree.map(np.asarray, ref._v2_hi_state))
    host = FleetConfig(**V5E, **_kw(40, hi=HIModel.make(), delegate=False))
    with pytest.raises(ValueError, match="delegation"):
        FleetEngine.from_config(host, device=CPU)


def _host_fleet(rng, n_dev=4, n=8, M=3):
    p_ed = rng.uniform(0.05, 0.2, (n_dev, n, M)).cumsum(axis=2)[:, :, ::-1]
    return RAPI.FleetProblem(
        p_ed=p_ed.copy(), p_es=rng.uniform(0.01, 0.05, (n_dev, n)),
        acc=np.sort(rng.uniform(0.5, 0.95, (n_dev, M + 1)), axis=1),
        T=np.ones(n_dev), real_mask=np.ones((n_dev, n), bool))


@pytest.mark.parametrize("policy,rule", [("hi_threshold", None),
                                         ("hi_bandit", "ucb")])
def test_online_solvers_match_reference(policy, rule):
    rng = np.random.default_rng(0)
    ref_fleet = _host_fleet(rng)
    fleet = convert.fleet_problem_from_numpy(ref_fleet)
    conf = rng.uniform(0.3, 0.95, (4, 8))
    obs_l, obs_e = rng.random((4, 8)) < 0.7, rng.random((4, 8)) < 0.9
    extra = {} if rule is None else {"rule": rule}
    ref_st, port_st = None, None
    for t in range(3):
        with reference_x64():
            want = RAPI.solve(ref_fleet, policy=policy, confidence=conf,
                              hi=RH.HIModel.make(), state=ref_st,
                              observed_local=obs_l, observed_es=obs_e, t=t,
                              **extra)
        got = PAPI.solve(fleet, policy=policy, confidence=conf,
                         hi=HIModel.make(), state=port_st,
                         observed_local=obs_l, observed_es=obs_e, t=t,
                         device=CPU, **extra)
        np.testing.assert_array_equal(got.assignment, want.assignment)
        np.testing.assert_array_equal(got.solver, want.solver)
        np.testing.assert_allclose(got.hi_theta, want.hi_theta, rtol=0,
                                   atol=1e-12)
        _assert_state_hi(got.hi_state, want.hi_state)
        ref_st, port_st = want.hi_state, got.hi_state
    # decide-only: the state comes back unchanged
    sol = PAPI.solve(fleet, policy=policy, confidence=conf,
                     hi=HIModel.make(), state=port_st, device=CPU, **extra)
    for f in HI_STATE_FIELDS:
        assert torch.equal(getattr(sol.hi_state, f), getattr(port_st, f))


def test_online_solvers_capabilities_and_validation():
    infos = PAPI.solvers()
    for name in ("hi_threshold", "hi_bandit"):
        assert infos[name].online and infos[name].batched
    assert not infos["amr2"].online
    rng = np.random.default_rng(1)
    fleet = convert.fleet_problem_from_numpy(_host_fleet(rng))
    conf = rng.uniform(0.3, 0.95, (4, 8))
    sol = PAPI.solve(fleet, policy="hi_threshold", confidence=conf,
                     hi=HIModel.make(), device=CPU)
    np.testing.assert_array_equal(sol.assignment == fleet.m, conf < 0.5)
    sol = PAPI.solve(fleet, policy="hi_bandit", confidence=conf,
                     hi=HIModel.make(), rule="exp3", device=CPU)
    grid = to_numpy(arm_grid(9))
    assert np.isin(sol.hi_theta, grid).all()
    np.testing.assert_array_equal(sol.assignment == fleet.m,
                                  conf < sol.hi_theta[:, None])
    with pytest.raises(ValueError, match="ucb.*exp3"):
        PAPI.solve(fleet, policy="hi_bandit", confidence=conf,
                   hi=HIModel.make(), rule="thompson", device=CPU)
    with pytest.raises(ValueError, match="confidence must be"):
        PAPI.solve(fleet, policy="hi_threshold", confidence=conf[:, :3],
                   device=CPU)
    st = HILearnerState.init(4, 9, 0.5, device=CPU)
    assert st.theta.tolist() == [0.5] * 4
