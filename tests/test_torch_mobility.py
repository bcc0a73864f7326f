"""The mobility scenario of the port (`repro_torch.core.mobility`, the
engine's routing, handover and per-cell admission, and the ``routed``
solver) against the reference.

* `validate_mobility` with the reference's messages;
* `route_cells` for both routings, finite and infinite radius, with
  uncovered devices: cells and coverage exact, link factors to 1e-12;
* `admit_mask_segmented` on tie-heavy demands (a few repeated values,
  zeros, uncovered devices) for S in {1, 3, 16} and k in {1, 2, 4}: the
  admitted set equal to the reference's and to the sequential oracle
  `admit_mask_cells_np`, the per-server loads equal to the oracle's bit
  for bit;
* one cell with an infinite radius reducing to the plain rollout bit for
  bit (replay and walk), and the walk's steps by distribution;
* the replayed rollout against the reference's, 3 cells, both routings,
  both LP methods, 10 periods: ``cell``, ``pos`` and ``n_handover``
  exact, integers exact, floats to 1e-9 (audit threshold 1.4, ROADMAP §3
  item 1);
* handover cold-starting the switching devices' bases in both
  directions and resetting their ES beliefs, never at period 0;
* chaos and mobility together against the reference (its fault draws
  replayed);
* ``policy="routed"`` through the front door against the reference's
  `RoutedSolver`.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import api as RAPI
from repro.api import engine as RE
from repro.core import faults as RF
from repro.core import mobility as RM
from repro.serving.fleet import make_fleet as ref_make_fleet
from repro.serving.queue import RequestQueue as RefQueue
from repro_torch import api as PAPI
from repro_torch import convert
from repro_torch.api import engine as PE
from repro_torch.core.mobility import (MobilityModel, admit_mask_cells_np,
                                       admit_mask_segmented, route_cells,
                                       validate_mobility)
from repro_torch.serving.fleet import make_fleet
from repro_torch.serving.queue import RequestQueue
from test_torch_parity_util import (reference_fault_draws, reference_x64,
                                    to_numpy)

V5E = dict(es_peak_flops=197e12, es_hbm_bw=819e9)
CLASSES = (128, 512, 1024)
D, PERIODS, SEED = 24, 10, 3
SHARED_STATE = tuple(f for f in PE.STATE_FIELDS
                     if f not in ("seed", "warm_basis"))


def _three_cells(n_devices, horizon, seed=3, radius=9.0):
    """The reference tests' geometry: 3 cells, unequal link rates,
    devices scattered around a home cell (some out of coverage)."""
    rng = np.random.default_rng(seed)
    cxy = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0]])
    trace = (rng.normal(scale=4.0, size=(horizon, n_devices, 2))
             + cxy[rng.integers(0, 3, n_devices)])
    return RM.MobilityModel.make(
        cell_xy=cxy, trace=trace, cell_rate=np.array([1.0, 0.8, 1.2]),
        radius=radius, link_alpha=0.5)


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the model and its validation
# ---------------------------------------------------------------------------
def test_model_and_validation_match_reference():
    ref = _three_cells(6, 4)
    mob = convert.mobility_from_numpy(ref)
    assert mob.n_cells == 3 and not mob.is_null()
    assert MobilityModel.none().is_null() and RM.MobilityModel.none(
    ).is_null()
    made = MobilityModel.make(cell_xy=ref.cell_xy, trace=ref.trace,
                              cell_rate=ref.cell_rate, radius=9.0,
                              link_alpha=0.5)
    for f in ("cell_xy", "cell_rate", "radius", "link_alpha", "walk_sigma",
              "trace"):
        np.testing.assert_array_equal(getattr(made, f), getattr(ref, f))
    S, nd = 2, 4
    good = dict(cell_xy=np.zeros((S, 2)), trace=np.zeros((3, nd, 2)),
                cell_rate=np.ones(S), radius=5.0)
    cases = (("float64", dict(cell_xy=np.zeros((S, 2), np.float32))),
             ("float64", dict(trace=np.zeros((3, nd, 2), np.float32))),
             ("strictly positive", dict(cell_rate=np.array([1.0, 0.0]))),
             ("cell_rate", dict(cell_rate=np.ones(S + 1))),
             ("trace", dict(trace=np.zeros((3, nd + 1, 2)))),
             ("cell_xy", dict(cell_xy=np.zeros((S, 3)))),
             ("radius", dict(radius=0.0)),
             ("divisible", dict(cell_xy=np.zeros((3, 2)),
                                cell_rate=np.ones(3))),
             ("mode", dict(mode="teleport")),
             ("routing", dict(routing="random")))
    for msg, over in cases:
        kw = {**good, **over}
        fields = dict(cell_xy=np.asarray(kw["cell_xy"]),
                      cell_rate=np.asarray(kw["cell_rate"]),
                      radius=np.asarray(kw["radius"]),
                      link_alpha=np.float64(0.0),
                      walk_sigma=np.float64(0.0),
                      trace=np.asarray(kw["trace"]))
        opts = dict(n_devices=nd, n_servers=S,
                    mode=kw.get("mode", "replay"),
                    routing=kw.get("routing", "nearest"))
        with pytest.raises(ValueError, match=msg) as got:
            validate_mobility(MobilityModel(**fields), **opts)
        with pytest.raises(ValueError, match=msg) as want:
            RM.validate_mobility(RM.MobilityModel(**fields), **opts)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("routing", ["nearest", "min_time"])
@pytest.mark.parametrize("radius", [6.0, np.inf])
def test_route_cells_matches_reference(routing, radius):
    ref = _three_cells(64, 2, seed=5, radius=radius)
    rng = np.random.default_rng(1)
    pos = np.asarray(ref.trace[0])
    load = rng.uniform(0.0, 1.5, 3)
    got = route_cells(_t(pos), convert.mobility_from_numpy(ref).to("cpu"),
                      _t(load), routing)
    with reference_x64():
        want = [np.asarray(w) for w in RM.route_cells(pos, ref, load,
                                                      routing)]
    cell, covered, link = (to_numpy(g) for g in got)
    np.testing.assert_array_equal(cell, want[0])
    np.testing.assert_array_equal(covered, want[1])
    np.testing.assert_allclose(link, want[2], atol=1e-12, rtol=0)
    assert got[0].dtype == torch.int32 and link.dtype == np.float64
    if np.isinf(radius):
        assert covered.all() and (cell >= 0).all()
    else:
        assert (~covered).any() and (cell[~covered] == -1).all()
        assert (link[~covered] == 1.0).all()
    # the infinite-radius unit-rate link factor is exactly 1.0
    unit = dataclasses.replace(convert.mobility_from_numpy(ref),
                               cell_rate=np.ones(3),
                               radius=np.float64(np.inf)).to("cpu")
    assert bool((route_cells(_t(pos), unit, _t(load), routing)[2]
                 == 1.0).all())


# ---------------------------------------------------------------------------
# segmented admission
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_cells", [1, 3, 16])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_admit_mask_segmented_matches_reference_and_oracle(n_cells, k):
    """Tie-heavy demands: a few repeated values (as roofline devices give),
    zeros, and uncovered devices; capacity set so that every cell rejects
    some."""
    rng = np.random.default_rng(10 * n_cells + k)
    n_dev = 40 * n_cells
    demands = rng.choice([0.0, 0.1, 0.2, 0.25, 0.3, 0.45, 0.7], n_dev)
    cell = rng.integers(0, n_cells, n_dev).astype(np.int32)
    cell[rng.uniform(size=n_dev) < 0.1] = -1
    T = 0.55 * 40 * 0.3 / k                     # over-subscribed cells
    adm, loads = admit_mask_segmented(_t(demands), _t(cell),
                                      _t(np.float64(T)), n_cells, k)
    want_adm, want_loads = admit_mask_cells_np(demands, cell, T, n_cells, k)
    with reference_x64():
        ref_adm, ref_loads = (np.asarray(x) for x in RM.admit_mask_segmented(
            demands, cell, T, n_cells, k))
    np.testing.assert_array_equal(to_numpy(adm), want_adm)
    np.testing.assert_array_equal(to_numpy(adm), ref_adm)
    np.testing.assert_array_equal(to_numpy(loads), want_loads)
    np.testing.assert_allclose(to_numpy(loads), ref_loads, atol=1e-12,
                               rtol=0)
    assert want_adm.any() and (~want_adm & (demands > 0)
                               & (cell >= 0)).any()
    assert not to_numpy(adm)[cell < 0].any()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _port_params(lp_method="tableau", threshold=1.4, n_devices=D,
                 n_servers=6, **kw):
    return PE.EngineParams.from_fleet(
        make_fleet(n_devices, seed=SEED, horizon=PERIODS, **V5E),
        RequestQueue(n_devices, CLASSES, rate=10.0, batch_max=12, seed=SEED),
        T=1.2, n_servers=n_servers, horizon=PERIODS, lp_method=lp_method,
        straggler_threshold=threshold, device="cpu", **kw)


def _ref_params(lp_method="tableau", n_devices=D, **kw):
    return RE.EngineParams.from_fleet(
        ref_make_fleet(n_devices, seed=SEED, horizon=PERIODS),
        RefQueue(n_devices, CLASSES, rate=10.0, batch_max=12, seed=SEED),
        T=1.2, n_servers=6, horizon=PERIODS, lp_method=lp_method,
        straggler_threshold=1.4, **kw)


@pytest.mark.parametrize("mode", ["replay", "walk"])
def test_s1_infinite_radius_reduces_bitwise(mode):
    base = _port_params(threshold=1.5)
    s0, m0 = PE.rollout(PE.init_state(base, device="cpu"), base, PERIODS,
                        device="cpu")
    mob = MobilityModel.make(cell_xy=np.zeros((1, 2)),
                             trace=np.zeros((PERIODS, D, 2)),
                             walk_sigma=2.0)
    armed = base.with_mobility(mob, mode=mode, routing="min_time",
                               mobility_seed=7)
    assert armed.mobility_mode == mode and armed.n_cells == 1
    s1, m1 = PE.rollout(PE.init_state(armed, device="cpu"), armed, PERIODS,
                        device="cpu")
    for f in PE.METRIC_FIELDS:
        assert torch.equal(getattr(m0, f), getattr(m1, f)), f
    for f in PE.STATE_FIELDS:
        if f not in ("pos", "cell"):
            assert torch.equal(getattr(s0, f), getattr(s1, f)), f
    assert bool((s1.cell == 0).all())
    assert int(m1.n_handover.sum()) == 0


def test_walk_steps_by_distribution():
    """The walk's steps (`engine._positions`): mean 0 and standard
    deviation ``walk_sigma`` within 5 standard errors; the same seed walks
    the same path, another seed another."""
    n_dev, sigma = 4096, 2.5
    base = _port_params(n_devices=n_dev, n_servers=1)
    mob = MobilityModel.make(cell_xy=np.zeros((1, 2)),
                             trace=np.zeros((1, n_dev, 2)), walk_sigma=sigma)
    params = base.with_mobility(mob, mode="walk", mobility_seed=3)
    state = PE.init_state(params, device="cpu")
    pos = [state.pos]
    for t in range(2):
        state = dataclasses.replace(state, pos=PE._positions(state, params,
                                                             t))
        pos.append(state.pos)
    steps = torch.cat([pos[1] - pos[0], pos[2] - pos[1]]).numpy().ravel()
    se = sigma / np.sqrt(steps.size)
    assert abs(steps.mean()) <= 5 * se
    assert abs(steps.std() - sigma) <= 5 * sigma / np.sqrt(2 * steps.size)
    fresh = PE.init_state(params, device="cpu")
    assert torch.equal(PE._positions(fresh, params, 0), pos[1])
    other = dataclasses.replace(params, mobility_seed=4)
    assert not torch.equal(PE._positions(fresh, other, 0), pos[1])
    # the walk drives the engine: one step moves every device
    small = _port_params().with_mobility(
        MobilityModel.make(cell_xy=np.zeros((1, 2)),
                           trace=np.zeros((1, D, 2)), walk_sigma=sigma),
        mode="walk", mobility_seed=3)
    s1, _m = PE.step(PE.init_state(small, device="cpu"), small,
                     device="cpu")
    assert bool((s1.pos != 0).all())


def _compare_rollouts(ps, pm, rs, rm):
    for f in PE.METRIC_FIELDS:
        a, b = to_numpy(getattr(pm, f)), np.asarray(getattr(rm, f))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    # the carried bases are not compared across packages (ROADMAP §3 item
    # 2); positions and cells exactly, other state to 1e-9
    for f in SHARED_STATE:
        a, b = to_numpy(getattr(ps, f)), np.asarray(getattr(rs, f))
        if f in ("pos", "cell"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        elif np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("routing,lp_method", [("nearest", "tableau"),
                                               ("nearest", "revised"),
                                               ("min_time", "tableau"),
                                               ("min_time", "revised")])
def test_replayed_rollout_matches_reference(routing, lp_method):
    ref_mob = _three_cells(D, PERIODS)
    ref = _ref_params(lp_method, mobility=ref_mob, routing=routing)
    port = _port_params(lp_method, mobility=convert.mobility_from_numpy(
        ref_mob), routing=routing)
    assert port.n_cells == 3 and port.servers_per_cell == 2
    with reference_x64():
        rs, rm = RE.rollout(RE.init_state(ref), ref, PERIODS)
    ps, pm = PE.rollout(PE.init_state(port, device="cpu"), port, PERIODS,
                        device="cpu")
    _compare_rollouts(ps, pm, rs, rm)
    hand = to_numpy(pm.n_handover)
    assert hand[0] == 0 and hand.sum() > 0
    assert to_numpy(pm.n_outage).sum() > 0          # uncovered devices
    assert tuple(ps.cell_load.shape) == (3,)


def _capture_period_inputs(monkeypatch, state, params):
    """The warm bases and priced ES table `step` hands to `_period`."""
    got = {}
    real = PE._period

    def spy(belief, warm, ci, take, drift, outage, es_tbl, p, **kw):
        got["warm"], got["es_belief"] = warm.clone(), es_tbl.clone()
        return real(belief, warm, ci, take, drift, outage, es_tbl, p, **kw)

    monkeypatch.setattr(PE, "_period", spy)
    PE.step(state, params, device="cpu")
    return got


def test_handover_cold_starts_both_directions(monkeypatch):
    """A cell switch either way cold-starts exactly the switching
    devices' bases and resets their ES beliefs to the nominal table, beside
    the outage-flip rule."""
    n_dev, periods = 6, 4
    base = _port_params(n_devices=n_dev, n_servers=2)
    outage = torch.zeros_like(base.outage)
    outage[3, 1] = True                     # device 3: outage flip at t=1
    params = dataclasses.replace(base, outage=outage)
    trace = np.zeros((periods, n_dev, 2))
    trace[:, 1] = [10.0, 0.0]               # device 1 lives at cell 1
    trace[1, 0] = [10.0, 0.0]               # device 0: cell 0 -> cell 1
    trace[1, 1] = [0.0, 0.0]                # device 1: cell 1 -> cell 0
    params = params.with_mobility(MobilityModel.make(
        cell_xy=np.array([[0.0, 0.0], [10.0, 0.0]]), trace=trace,
        radius=50.0))
    wb = torch.arange(params.n_basis_rows, dtype=torch.int32).repeat(
        n_dev, 1)
    belief = params.p_es * 3.0
    state = dataclasses.replace(
        PE.init_state(params, device="cpu"),
        period=torch.tensor(1, dtype=torch.int32), warm_basis=wb,
        cell=torch.tensor([0, 1, 0, 0, 0, 0], dtype=torch.int32),
        p_es_belief=belief)
    got = _capture_period_inputs(monkeypatch, state, params)
    assert bool((got["warm"][[0, 1, 3]] == -1).all())
    assert torch.equal(got["warm"][[2, 4, 5]], wb[[2, 4, 5]])
    assert torch.equal(got["es_belief"][[0, 1]], params.p_es[[0, 1]])
    assert torch.equal(got["es_belief"][[2, 3, 4, 5]],
                       belief[[2, 3, 4, 5]])
    nxt, m = PE.step(state, params, device="cpu")
    assert int(m.n_handover) == 2
    assert nxt.cell.tolist() == [1, 0, 0, 0, 0, 0]
    # period 0: moving from the initial "no cell" is not a handover
    fresh = dataclasses.replace(
        params, outage=torch.zeros_like(params.outage))
    state0 = dataclasses.replace(PE.init_state(fresh, device="cpu"),
                                 warm_basis=wb)
    got0 = _capture_period_inputs(monkeypatch, state0, fresh)
    assert torch.equal(got0["warm"], wb)
    _s, m0 = PE.step(state0, fresh, device="cpu")
    assert int(m0.n_handover) == 0


@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_chaos_and_mobility_together_match_reference(lp_method):
    ref_mob = _three_cells(D, PERIODS, seed=4)
    ref_fm = RF.FaultModel.make(link_degrade_prob=0.5, link_degrade_mag=2.0,
                                loss_rate=0.1, straggler_prob=0.1,
                                straggler_mult=1.8)
    ref = _ref_params(lp_method, mobility=ref_mob, routing="min_time",
                      faults=ref_fm, fault_seed=5)
    draws = reference_fault_draws(ref_fm, 5, D, 12, 2, PERIODS)
    port = _port_params(
        lp_method, mobility=convert.mobility_from_numpy(ref_mob),
        routing="min_time", faults=convert.fault_model_from_numpy(ref_fm),
        fault_seed=5, fault_trace=convert.fault_trace_from_numpy(draws,
                                                                 "cpu"))
    with reference_x64():
        rs, rm = RE.rollout(RE.init_state(ref), ref, PERIODS)
    ps, pm = PE.rollout(PE.init_state(port, device="cpu"), port, PERIODS,
                        device="cpu")
    _compare_rollouts(ps, pm, rs, rm)
    assert int(to_numpy(pm.n_es_audit_updates).sum()) > 0
    assert int(to_numpy(pm.n_handover).sum()) > 0


def test_params_carried_across_by_convert():
    ref_mob = _three_cells(D, PERIODS)
    ref = _ref_params(mobility=ref_mob, routing="min_time",
                      faults=RF.FaultModel.make(loss_rate=0.2),
                      fault_seed=6, max_retries=1)
    fields = {f: getattr(ref, f) for f in RE._PARAM_LEAVES + RE._PARAM_AUX
              if f != "hi"}
    carried = convert.params_from_numpy(fields, "cpu")
    port = _port_params(mobility=convert.mobility_from_numpy(ref_mob),
                        routing="min_time",
                        faults=convert.fault_model_from_numpy(ref.faults),
                        fault_seed=6, max_retries=1)
    for f in PE.PARAM_ARRAYS:
        assert torch.equal(getattr(port, f), getattr(carried, f)), f
    for f in PE.PARAM_CONFIG:
        assert getattr(port, f) == getattr(carried, f) == getattr(ref, f), f
    assert carried.faults == port.faults
    for f in ("cell_xy", "cell_rate", "radius", "trace"):
        assert torch.equal(getattr(carried.mobility, f),
                           getattr(port.mobility, f)), f
    with reference_x64():
        rstate = RE.init_state(ref)
    state = convert.state_from_numpy(
        {f: np.asarray(getattr(rstate, f)) for f in PE.STATE_FIELDS
         if f != "seed"}, "cpu")
    fresh = PE.init_state(port, device="cpu")
    for f in PE.STATE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(fresh, f)), f


# ---------------------------------------------------------------------------
# the routed solver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("routing", ["nearest", "min_time"])
def test_routed_solver_matches_reference(routing):
    B, n, m = 12, 6, 2
    rng = np.random.default_rng(2)
    from repro.core import instances as ref_instances
    insts = [ref_instances.random_instance(n, m, 1.0, seed=s)
             for s in range(B)]
    fleet = RAPI.FleetProblem(
        p_ed=np.stack([i.p_ed for i in insts]),
        p_es=np.stack([i.p_es for i in insts]),
        acc=np.stack([i.acc for i in insts]), T=np.ones(B),
        real_mask=np.ones((B, n), bool))
    ref_mob = _three_cells(B, 1, seed=2, radius=6.0)
    pos = np.asarray(ref_mob.trace[0]) + rng.normal(scale=1.0, size=(B, 2))
    with reference_x64():
        want = RAPI.solve(fleet, policy="routed", positions=pos,
                          mobility=ref_mob, routing=routing)
    got = PAPI.solve(convert.fleet_problem_from_numpy(fleet),
                     policy="routed", positions=pos,
                     mobility=convert.mobility_from_numpy(ref_mob),
                     routing=routing, device="cpu")
    w, g = convert.solution_fields(want), convert.solution_fields(got)
    for f in ("assignment", "status", "solver", "n_fractional"):
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    np.testing.assert_allclose(g["lp_accuracy"], w["lp_accuracy"],
                               atol=1e-9, rtol=0)
    np.testing.assert_array_equal(got.cell, want.cell)
    np.testing.assert_allclose(got.link_factor, np.asarray(want.link_factor),
                               atol=1e-12, rtol=0)
    assert (got.cell == -1).any() and (got.solver == "routed").all()
    # uncovered lanes plan local-only; the solution prices the caller's
    # problem
    assert (got.assignment[got.cell == -1] < m).all()
    assert got.problem.p_es is not None
    with pytest.raises(ValueError, match="positions"):
        PAPI.solve(convert.fleet_problem_from_numpy(fleet), policy="routed",
                   positions=pos[:-1],
                   mobility=convert.mobility_from_numpy(ref_mob),
                   device="cpu")
