"""The deprecated planner shims (`repro_torch.serving.planner`) and the
legacy `Plan` input of `execute`, against the reference's and against the
front door, on the CPU.

Each shim warns once per process and returns what `api.solve` /
`solve_many` return; `execute` runs a legacy `Plan` as it runs the
`Solution` it wraps.
"""
import warnings

import numpy as np
import pytest

from repro.core import instances as RI
from repro.core.types import InstanceBatch as RefBatch
from repro.serving import planner as ref_planner
from repro_torch import api as PAPI
from repro_torch.core.types import InstanceBatch, OffloadInstance
from repro_torch.serving import executor, planner
from test_torch_parity_util import reference_x64


def _insts(seed, n=6, count=4):
    return [RI.random_instance(n, 2, T=0.5, seed=seed + k)
            for k in range(count)]


def _port(inst):
    return OffloadInstance(p_ed=inst.p_ed, p_es=inst.p_es, acc=inst.acc,
                           T=inst.T)


@pytest.mark.parametrize("policy", ["auto", "amr2", "dual"])
def test_shims_warn_once_and_equal_the_front_door(policy):
    insts = _insts(3)
    port = [_port(i) for i in insts]
    batch = InstanceBatch.stack(port)
    planner._reset_deprecation_warnings()
    calls = (
        ("plan", lambda: planner.plan(port[0], policy=policy,
                                      device="cpu")),
        ("plan_batch", lambda: planner.plan_batch(port, policy=policy,
                                                  device="cpu")),
        ("plan_batch_arrays", lambda: planner.plan_batch_arrays(
            batch, policy=policy, device="cpu")),
        ("replan_without_es", lambda: planner.replan_without_es(
            port[0], device="cpu")),
        ("replan_without_es_batch", lambda: planner.replan_without_es_batch(
            batch, policy=policy, device="cpu")),
    )
    out = {}
    for name, call in calls:
        with pytest.warns(DeprecationWarning, match=name):
            out[name] = call()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            call()                                 # once per process
    one = PAPI.solve(PAPI.Problem.from_instance(port[0]), policy=policy,
                     device="cpu")
    np.testing.assert_array_equal(out["plan"].schedule.assignment,
                                  one.assignment)
    assert out["plan"].policy == one.solver_name
    many = PAPI.solve_many([PAPI.Problem.from_instance(i) for i in port],
                           policy=policy, device="cpu")
    for p, s in zip(out["plan_batch"], many):
        np.testing.assert_array_equal(p.schedule.assignment, s.assignment)
    fleet = PAPI.solve(PAPI.FleetProblem.from_batch(batch), policy=policy,
                       device="cpu")
    np.testing.assert_array_equal(out["plan_batch_arrays"].assignment,
                                  fleet.assignment)
    es_off = PAPI.solve(PAPI.FleetProblem.from_batch(batch), policy=policy,
                        es_disabled=True, device="cpu")
    np.testing.assert_array_equal(out["replan_without_es_batch"].assignment,
                                  es_off.assignment)
    assert (out["replan_without_es"].schedule.assignment < 2).all()
    # and the reference's shims plan the same
    ref_planner._reset_deprecation_warnings()
    with reference_x64(), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_planner.plan_batch_arrays(RefBatch.stack(insts),
                                             policy=policy)
    np.testing.assert_array_equal(out["plan_batch_arrays"].assignment,
                                  want.assignment)
    with pytest.raises(ValueError, match="bound-only"):
        planner.plan(port[0], policy="lp", device="cpu")


@pytest.mark.parametrize("es_fail", [False, True])
def test_execute_accepts_a_legacy_plan(es_fail):
    inst = _port(_insts(7, n=8, count=1)[0])
    planner._reset_deprecation_warnings()
    with pytest.warns(DeprecationWarning):
        legacy = planner.plan(inst, policy="amr2", device="cpu")
    sol = PAPI.solve(PAPI.Problem.from_instance(inst), policy="amr2",
                     device="cpu")
    m = inst.m
    assert (sol.assignment == m).any()        # the plan offloads

    def ed(i):
        return lambda jobs: [(i, j) for j in jobs]

    jobs = list(range(inst.n))
    got = executor.execute(legacy, [ed(i) for i in range(m)],
                           lambda jobs: [("es", j) for j in jobs], jobs,
                           es_fail=es_fail, device="cpu")
    want = executor.execute(sol, [ed(i) for i in range(m)],
                            lambda jobs: [("es", j) for j in jobs], jobs,
                            es_fail=es_fail, device="cpu")
    assert got.results == want.results
    np.testing.assert_array_equal(got.status, want.status)
    assert got.predicted_makespan == pytest.approx(legacy.predicted_makespan)
    assert got.predicted_makespan == pytest.approx(float(sol.makespan))
    assert got.replanned == want.replanned == es_fail
    assert got.n_dropped == 0
