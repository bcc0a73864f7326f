"""The port's fleet engine and its pieces against the reference.

* `admit_mask_pool` and `greedy_local_fill` on seeded data;
* `make_fleet` / `RequestQueue.presample` (with the reference's TPU v5e ES
  constants passed explicitly — the port has no ES default);
* `EngineParams.from_fleet` against the reference's params carried across
  by `repro_torch.convert`;
* the slice as a whole: an 8-period `rollout` at 16 devices, 12 jobs, 2
  local models and 2 servers, replayed arrivals, for both LP methods,
  against the reference `rollout`.

Tolerances: integer metrics, assignments and admission exact; float
metrics and state to atol 1e-9; carried warm bases as label sets per
device (the reference's own bar between its two LP methods: a basis row's
slot depends on the pivot path).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import engine as RE
from repro.core import instances as ref_instances
from repro.core.faults import greedy_local_fill as ref_greedy
from repro.core import hi as RH
from repro.core.mobility import admit_mask_pool as ref_admit
from repro.serving.fleet import make_fleet as ref_make_fleet
from repro.serving.queue import RequestQueue as RefQueue
from repro_torch import convert
from repro_torch.api import engine as PE
from repro_torch.core import instances
from repro_torch.core.faults import FaultModel, greedy_local_fill
from repro_torch.core.hi import HIModel
from repro_torch.core.mobility import MobilityModel, admit_mask_pool
from repro_torch.serving.fleet import make_fleet
from repro_torch.serving.queue import RequestQueue
from test_torch_parity_util import reference_x64, to_numpy

# the reference's roofline ES defaults (TPU v5e), passed explicitly
V5E = dict(es_peak_flops=197e12, es_hbm_bw=819e9)
CLASSES = (128, 512, 1024)
D, PERIODS, SEED = 16, 8, 3
# state fields both packages carry (the port's Poisson ``seed`` stands in
# for the reference's jax PRNG ``key``)
SHARED_STATE = tuple(f for f in PE.STATE_FIELDS if f != "seed")


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_admit_mask_pool_matches_reference(k):
    rng = np.random.default_rng(k)
    demands = rng.choice([0.0, 0.1, 0.25, 0.4, 0.7], 37) * \
        rng.uniform(0.9, 1.1, 37).round(1)            # ties and zeros
    T = 1.0
    got = admit_mask_pool(_t(demands), torch.tensor(T, dtype=torch.float64),
                          k)
    with reference_x64():
        want = ref_admit(np.asarray(demands), T, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    assert 0 < to_numpy(got[0]).sum() < (demands > 0).sum()


def test_greedy_local_fill_matches_reference():
    rng = np.random.default_rng(0)
    lat = rng.uniform(0.05, 0.5, (20, 12, 3))
    acc = np.sort(rng.uniform(0.3, 0.9, (20, 3)), axis=1)
    budget = rng.uniform(0.2, 2.0, 20)
    elig = rng.uniform(size=(20, 12)) < 0.7
    got = greedy_local_fill(_t(lat), _t(acc), _t(budget), _t(elig))
    with reference_x64():
        want = ref_greedy(lat, acc, budget, elig)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


def test_make_fleet_and_presample_match_reference():
    ref = ref_make_fleet(40, seed=5, horizon=12)
    got = make_fleet(40, seed=5, horizon=12, **V5E)
    for r, g in zip(ref, got):
        assert g.name == r.name and g.profile.name == r.profile.name
        for f in ("p_ed", "p_es", "acc"):
            np.testing.assert_array_equal(getattr(g.profile, f),
                                          getattr(r.profile, f))
        for f in ("drift", "outage"):
            a, b = getattr(g, f), getattr(r, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    qr = RefQueue(40, CLASSES, rate=6.0, batch_max=12, seed=5)
    qg = RequestQueue(40, CLASSES, rate=6.0, batch_max=12, seed=5)
    for a, b in zip(qg.presample(12), qr.presample(12)):
        np.testing.assert_array_equal(a, b)


def test_instance_generators_match_reference():
    for name in ("PAPER_ACC", "PAPER_DIMS", "PAPER_P_ED", "PAPER_P_ES_PROC",
                 "PAPER_COMM"):
        a, b = getattr(instances, name), getattr(ref_instances, name)
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    for seed in (0, 1):
        pairs = ((instances.paper_instance(9, 1.2, seed),
                  ref_instances.paper_instance(9, 1.2, seed)),
                 (instances.random_instance(9, 3, 1.2, seed),
                  ref_instances.random_instance(9, 3, 1.2, seed)),
                 (instances.identical_instance(9, 3, 1.2, seed),
                  ref_instances.identical_instance(9, 3, 1.2, seed)))
        for got, want in pairs:
            for f in ("p_ed", "p_es", "acc"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            assert got.T == want.T
    prof = make_fleet(2, seed=1, horizon=4, **V5E)[0].profile
    ref_prof = ref_make_fleet(2, seed=1, horizon=4)[0].profile
    jobs = np.array([1024, 128, 512, 128])
    got, want = prof.instance(jobs, 1.2), ref_prof.instance(jobs, 1.2)
    np.testing.assert_array_equal(got.p_ed, want.p_ed)
    np.testing.assert_array_equal(got.p_es, want.p_es)


def _fleet_pair(lp_method, straggler_threshold):
    ref = RE.EngineParams.from_fleet(
        ref_make_fleet(D, seed=SEED, horizon=PERIODS),
        RefQueue(D, CLASSES, rate=10.0, batch_max=12, seed=SEED),
        T=1.2, n_servers=2, horizon=PERIODS, lp_method=lp_method,
        straggler_threshold=straggler_threshold)
    port = PE.EngineParams.from_fleet(
        make_fleet(D, seed=SEED, horizon=PERIODS, **V5E),
        RequestQueue(D, CLASSES, rate=10.0, batch_max=12, seed=SEED),
        T=1.2, n_servers=2, horizon=PERIODS, lp_method=lp_method,
        straggler_threshold=straggler_threshold, device="cpu")
    return ref, port


def _ref_fields(params):
    return {f: getattr(params, f) for f in RE._PARAM_LEAVES + RE._PARAM_AUX
            if f not in ("faults", "mobility", "hi")}


def test_from_fleet_matches_reference_params_carried_across():
    ref, port = _fleet_pair("tableau", 1.5)
    carried = convert.params_from_numpy(_ref_fields(ref), "cpu")
    for f in PE.PARAM_ARRAYS:
        a, b = getattr(port, f), getattr(carried, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    for f in PE.PARAM_CONFIG:
        assert getattr(port, f) == getattr(carried, f) == getattr(ref, f), f


@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_rollout_matches_reference(lp_method):
    """The slice end to end: 8 periods of arrivals, warm-started planning,
    admission, bumped-lane replans and the EMA audit.

    The audit threshold is 1.4 rather than the default 1.5: with
    `make_fleet`'s 3x stragglers and EMA 0.5, a straggler's belief becomes
    exactly 2x its base after one update, so every later audit compares
    3S / 2S against 1.5 — an exact tie that each side resolves by the
    rounding of its own sums (ROADMAP §3; the tie at 1.5 is pinned by
    `test_rollout_at_default_threshold_pins_the_audit_tie`)."""
    ref, port = _fleet_pair(lp_method, 1.4)
    with reference_x64():
        rs, rm = RE.rollout(RE.init_state(ref), ref, PERIODS)
    ps, pm = PE.rollout(PE.init_state(port, device="cpu"), port, PERIODS,
                        device="cpu")
    for f in PE.METRIC_FIELDS:
        a, b = to_numpy(getattr(pm, f)), np.asarray(getattr(rm, f))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in SHARED_STATE:
        a, b = to_numpy(getattr(ps, f)), np.asarray(getattr(rs, f))
        if f == "warm_basis":
            np.testing.assert_array_equal(np.sort(a, 1), np.sort(b, 1))
        elif np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    m = to_numpy(pm.n_backpressured)
    assert m.sum() > 0 and to_numpy(pm.n_straggler_updates).sum() > 0


@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_rollout_at_default_threshold_pins_the_audit_tie(lp_method):
    """The same rollout at the default threshold 1.5, where device 5's
    audit in period 3 ties it exactly (ROADMAP §3, item 1): the port
    updates that belief and the reference does not.  Pinned exactly, so
    the test fails when the divergence grows, moves or goes away; every
    other metric and every other device's state still match."""
    ref, port = _fleet_pair(lp_method, 1.5)
    with reference_x64():
        rs, rm = RE.rollout(RE.init_state(ref), ref, PERIODS)
    ps, pm = PE.rollout(PE.init_state(port, device="cpu"), port, PERIODS,
                        device="cpu")
    np.testing.assert_array_equal(np.asarray(rm.n_straggler_updates),
                                  [0, 0, 2, 1, 0, 2, 0, 0])
    np.testing.assert_array_equal(to_numpy(pm.n_straggler_updates),
                                  [0, 0, 2, 2, 0, 2, 0, 0])
    for f in PE.METRIC_FIELDS:
        if f == "n_straggler_updates":
            continue
        a, b = to_numpy(getattr(pm, f)), np.asarray(getattr(rm, f))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    tied = np.arange(D) == 5
    np.testing.assert_array_equal(to_numpy(ps.n_updates),
                                  np.asarray(rs.n_updates) + tied)
    # the one extra update scales the belief by (1 - ema) + ema * 1.5
    scale = np.where(tied, (1 - port.ema) + port.ema * 1.5, 1.0)
    np.testing.assert_allclose(to_numpy(ps.p_ed),
                               np.asarray(rs.p_ed) * scale[:, None, None],
                               atol=1e-9, rtol=1e-12)
    for f in SHARED_STATE:
        if f in ("n_updates", "p_ed"):
            continue
        a, b = to_numpy(getattr(ps, f)), np.asarray(getattr(rs, f))
        if f == "warm_basis":
            np.testing.assert_array_equal(np.sort(a, 1), np.sort(b, 1))
        elif np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_step_sequence_equals_rollout():
    _, port = _fleet_pair("revised", 1.5)
    s0 = PE.init_state(port, device="cpu")
    sr, mr = PE.rollout(s0, port, 4, device="cpu")
    s = s0
    for t in range(4):
        s, m = PE.step(s, port, device="cpu")
        for f in PE.METRIC_FIELDS:
            assert torch.equal(getattr(m, f), getattr(mr, f)[t]), f
    for f in PE.STATE_FIELDS:
        assert torch.equal(getattr(s, f), getattr(sr, f)), f


def test_unported_paths_raise_with_roadmap_item():
    """Dual and Poisson arrivals (items 5 and 4) and item 9 — chaos,
    mobility, HI and the differentiable rollout — build and step (HI and
    the relaxation refuse bad arguments with the reference's
    `ValueError`); the sharded engine (item 10) takes ``shard_by_cell``
    and refuses armed HI and differentiable params with the reference's
    `ValueError` before it reads the mesh."""
    _, port = _fleet_pair("tableau", 1.5)
    devs = make_fleet(4, seed=0, horizon=4, **V5E)
    q = RequestQueue(4, CLASSES, rate=4.0, batch_max=6, seed=0)
    mob = MobilityModel.make(cell_xy=np.zeros((1, 2)),
                             trace=np.zeros((4, 4, 2)))
    for kwargs in (dict(policy="dual"), dict(arrivals="poisson"),
                   dict(faults=FaultModel.make(loss_rate=0.5)),
                   dict(mobility=mob)):
        params = PE.EngineParams.from_fleet(devs, q, T=1.2, horizon=4,
                                            device="cpu", **kwargs)
        state, m = PE.step(PE.init_state(params, device="cpu"), params,
                           device="cpu")
        assert int(state.period) == 1 and int(m.n_unsolved) == 0
        assert int(m.n_jobs) + int(m.backlog) > 0
    assert params.mobility_mode == "replay" and params.n_cells == 1
    armed = port.with_hi(HIModel.make(), rule="ucb", n_arms=5)
    state, m = PE.step(PE.init_state(armed, device="cpu"), armed,
                       device="cpu")
    assert int(m.n_hi_offloaded + m.n_hi_local_final) == int(m.n_jobs)
    assert 0 < float(state.hi.arms_cnt.sum()) <= armed.n_devices
    with pytest.raises(ValueError, match="unknown HI rule"):
        port.with_hi(HIModel.make(), rule="softmax")
    diff = port.with_differentiable(True)
    assert diff.differentiable and diff.smooth_mode == "st"
    with pytest.raises(ValueError, match="smooth_mode"):
        port.with_differentiable(True, smooth_mode="gumbel")
    by_cell = params.with_mobility(mob, shard_by_cell=True)
    assert by_cell.shard_by_cell and not params.shard_by_cell
    # unsharded, the flag changes nothing
    s0 = PE.init_state(by_cell, device="cpu")
    for a, b in zip(PE.step(s0, by_cell, device="cpu"),
                    PE.step(s0, params.with_mobility(mob), device="cpu")):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name
    s_hi = PE.init_state(armed, device="cpu")
    for call in (lambda: PE.shard(s_hi, armed, None),
                 lambda: PE.step_sharded(s_hi, armed, None),
                 lambda: PE.rollout_sharded(s_hi, armed, 2, None)):
        with pytest.raises(ValueError, match="sharded entry points do not "
                                             "support armed HI"):
            call()
    s_diff = PE.init_state(diff, device="cpu")
    for call in (lambda: PE.step_sharded(s_diff, diff, None),
                 lambda: PE.rollout_sharded(s_diff, diff, 2, None)):
        with pytest.raises(ValueError, match="sharded entry points do not "
                                             "support differentiable"):
            call()
    ref, _ = _fleet_pair("tableau", 1.5)
    ref_hi = ref.with_hi(RH.HIModel.make(theta0=0.4), rule="threshold",
                         hi_seed=3)
    carried = convert.params_from_numpy(
        {**_ref_fields(ref_hi), "hi": ref_hi.hi}, "cpu")
    assert carried.hi_rule == "threshold" and carried.hi_seed == 3
    assert float(carried.hi.theta0) == 0.4
    sbc = convert.params_from_numpy(
        {**_ref_fields(ref.with_mobility(None, shard_by_cell=True))}, "cpu")
    assert sbc.shard_by_cell is True and sbc.mobility_mode == "off"
    with pytest.raises(ValueError, match="max_retries"):
        PE.EngineParams.from_fleet(devs, q, T=1.2, horizon=4, device="cpu",
                                   max_retries=-1)


def test_float64_and_horizon_guards():
    _, port = _fleet_pair("tableau", 1.5)
    state = PE.init_state(port, device="cpu")
    bad = PE.EngineState(**{**{f: getattr(state, f)
                               for f in PE.STATE_FIELDS},
                            "p_ed": state.p_ed.float()})
    with pytest.raises(TypeError, match="state.p_ed"):
        PE.step(bad, port, device="cpu")
    with pytest.raises(ValueError, match="covers 8 periods"):
        PE.rollout(state, port, PERIODS + 1, device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    """No silent CPU fallback: without ``device=`` the entry points ask for
    the card, and with none visible they raise."""
    _, port = _fleet_pair("tableau", 1.5)
    state = PE.init_state(port, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    devs = make_fleet(4, seed=0, horizon=4, **V5E)
    q = RequestQueue(4, CLASSES, rate=4.0, batch_max=6, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.EngineParams.from_fleet(devs, q, T=1.2, horizon=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.init_state(port)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.rollout(state, port, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PE.step(state, port)
