"""The port's host `FleetEngine` against `repro.serving.fleet.FleetEngine`,
on the CPU: same devices, same queue, ``policy="auto"``, the default
straggler threshold 1.5.

* a single-class fleet (``classes=(512,)``, rate 12, ``batch_max`` 12):
  full devices have identical jobs and go to AMDP, devices with phantom
  slots to AMR^2, every period, and admission bumps devices into the
  ES-disabled replan;
* the 3-class `make_fleet` with outages and stragglers;
* ``policy="greedy"``, which has no batched path and plans device by
  device (the reference's NumPy backend), with devices carried across by
  `repro_torch.convert.device_specs_from_numpy`.

Bar: every `FleetPeriodStats` field but ``plan_seconds`` — integers
exact, floats to 1e-9 — and each device's final ``n_updates`` and belief
``p_ed`` (to 1e-12).  The pricing and the audit are host NumPy in both
packages, so the audit at 1.5 decides as the reference does.
"""
import dataclasses

import numpy as np
import pytest

from repro.serving.fleet import FleetEngine as RefEngine
from repro.serving.fleet import make_fleet as ref_make_fleet
from repro.serving.queue import RequestQueue as RefQueue
from repro_torch import convert
from repro_torch.core.hi import HIModel
from repro_torch.core.faults import FaultModel
from repro_torch.serving.fleet import FleetEngine, FleetPeriodStats, make_fleet
from repro_torch.serving.queue import RequestQueue
from test_torch_parity_util import reference_x64

# the reference's roofline ES defaults (TPU v5e), passed explicitly
V5E = dict(es_peak_flops=197e12, es_hbm_bw=819e9)
FLOAT_ATOL = 1e-9


def _compare(ref, port, periods):
    with reference_x64():
        want = ref.run(periods)
    got = port.run(periods)
    assert len(got) == len(want) == periods
    fields = [f.name for f in dataclasses.fields(FleetPeriodStats)]
    assert fields == [f.name for f in dataclasses.fields(want[0])]
    for w, g in zip(want, got):
        for f in fields:
            if f == "plan_seconds":
                continue
            a, b = getattr(w, f), getattr(g, f)
            if isinstance(a, float):
                assert abs(a - b) <= FLOAT_ATOL, (w.period, f, a, b)
            else:
                assert a == b, (w.period, f, a, b)
    for dr, dp in zip(ref.devices, port.devices):
        assert dp.n_updates == dr.n_updates
        np.testing.assert_allclose(dp.profile.p_ed, dr.profile.p_ed,
                                   rtol=0, atol=1e-12)
    return want, got


def _engines(D, classes, periods, seed, rate, n_servers, **kw):
    ref = RefEngine(ref_make_fleet(D, classes=classes, seed=seed,
                                   horizon=periods),
                    RefQueue(D, classes, rate=rate, batch_max=12, seed=seed),
                    T=1.2, n_servers=n_servers, policy="auto")
    port = FleetEngine(make_fleet(D, classes=classes, seed=seed,
                                  horizon=periods, **V5E),
                       RequestQueue(D, classes, rate=rate, batch_max=12,
                                    seed=seed),
                       T=1.2, n_servers=n_servers, policy="auto",
                       device="cpu", **kw)
    return ref, port


def test_single_class_fleet_splits_between_both_solvers():
    ref, port = _engines(48, (512,), 5, 7, 12.0, 3)
    _, got = _compare(ref, port, 5)
    for log, stats in zip(port.solver_log, got):
        assert log["plan"]["amdp"] > 0 and log["plan"]["amr2"] > 0
        assert stats.n_backpressured > 0
        assert sum(log["replan"].values()) == stats.n_backpressured
    assert sum(s.n_straggler_updates for s in got) > 0


def test_three_class_fleet_with_outages_and_stragglers():
    ref, port = _engines(48, (128, 512, 1024), 6, 4, 10.0, 4)
    _, got = _compare(ref, port, 6)
    assert sum(s.n_outage for s in got) > 0
    assert sum(s.n_straggler_updates for s in got) > 0
    summary, want_summary = port.summary(), ref.summary()
    for k in ("periods", "jobs", "mean_job_accuracy", "violation_rate",
              "backpressure_rate", "straggler_updates", "final_backlog"):
        assert summary[k] == pytest.approx(want_summary[k], abs=1e-12), k


def test_greedy_sequential_matches_reference_numpy_backend():
    classes = (128, 512, 1024)
    specs = ref_make_fleet(24, classes=classes, seed=5, horizon=4)
    ref = RefEngine(specs, RefQueue(24, classes, rate=9.0, batch_max=12,
                                    seed=5),
                    T=1.2, n_servers=2, policy="greedy", backend="numpy")
    port = FleetEngine(convert.device_specs_from_numpy(specs),
                       RequestQueue(24, classes, rate=9.0, batch_max=12,
                                    seed=5),
                       T=1.2, n_servers=2, policy="greedy", device="cpu")
    _compare(ref, port, 4)


def test_unported_configurations_raise():
    classes = (128, 512, 1024)

    def engine(**kw):
        return FleetEngine(make_fleet(4, classes=classes, seed=0, horizon=2,
                                      **V5E),
                           RequestQueue(4, classes, seed=0), T=1.2,
                           device="cpu", **kw)

    # a one-group amr2 / dual fleet delegates to the tensor engine now
    # (ROADMAP §1 items 5 and 7) and runs, chaos and HI armed too (item
    # 9); either on the host pipeline raises the reference's ValueError
    fm = FaultModel.make(loss_rate=0.5)
    for policy in ("amr2", "dual"):
        for faults in (None, fm):
            eng = engine(policy=policy, faults=faults)
            assert eng._v2_params is not None
            assert eng._v2_params.chaos == (faults is not None)
            assert eng.run(1)[0].n_devices == 4
    assert engine(policy="auto")._v2_params is None
    assert engine(policy="auto", faults=FaultModel.none()).run(1)
    with pytest.raises(ValueError, match="'torch'"):
        engine(policy="amr2", backend="jax")
    with pytest.raises(ValueError, match="delegation"):
        engine(policy="auto", faults=fm)
    with pytest.raises(ValueError, match="hierarchical inference needs"):
        engine(policy="auto", hi=HIModel.make())
    armed = engine(policy="amr2", hi=HIModel.make(), hi_rule="fixed")
    stats = armed.run(1)[0]
    assert stats.n_hi_offloaded + stats.n_hi_local_final == stats.n_jobs
    with pytest.raises(ValueError, match="bound-only"):
        engine(policy="lp")
    with pytest.raises(ValueError, match="unknown solver"):
        engine(policy="simplex")
    host = engine(policy="amr2", delegate=False)
    assert host._v2_params is None and host.run(1)[0].n_devices == 4
