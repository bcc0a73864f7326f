"""The names the LM examples use (ROADMAP §1 item 11, rest), held exactly
against the reference: `Schedule.counts()` / `summary()` (character for
character on the same plan), `OffloadInstance.es_index` / `p(j, i)` and
the `ES` alias, `Problem.es_index`, the package exports of `core`,
`serving` (its HI names) and `data`, and the dataclass defaults the
reference gives (`BatchLPResult.warm`, `ExecutionReport.status`,
`PeriodStats.n_dropped`)."""
import dataclasses

import jax  # noqa: F401  (the reference runs beside the port)
import numpy as np
import pytest
import torch  # noqa: F401

import repro.api as ref_api
import repro.core as ref_core
import repro.core.lp as ref_lp
import repro.core.problem as ref_problem
import repro.core.types as ref_types
import repro.data as ref_data
import repro.serving as ref_serving
import repro.serving.executor as ref_executor
import repro.serving.runtime as ref_runtime
import repro_torch.core as core
import repro_torch.data as data
import repro_torch.serving as serving
from repro_torch.api import solve
from repro_torch.core import lp, problem, types
from repro_torch.serving import executor, runtime

from test_torch_parity_util import reference_x64

# the port keeps these of `repro.core.__all__` as modules (the reference
# shadows each module with its function)
KEPT_AS_MODULES = {"amr2", "amdp"}
# exported by the port's `core` beyond the reference's list
PORT_ONLY = {"dual_one_batch", "simplex_batch_grad", "HIModel",
             "HILearnerState", "arm_grid", "sample_confidence",
             "presample_stream", "hi_period", "validate_hi"}

INSTANCES = {
    "quickstart": lambda c: c.paper_instance(30, T=2.0, seed=0),
    "paper_tight": lambda c: c.paper_instance(12, T=0.6, seed=3),
    "random": lambda c: c.random_instance(20, 3, T=1.0, seed=5),
    "identical": lambda c: c.identical_instance(16, 2, T=1.5, seed=1),
}


@pytest.mark.parametrize("name", sorted(INSTANCES))
@pytest.mark.parametrize("policy", ["auto", "amr2", "greedy"])
def test_schedule_summary_and_counts_equal_the_reference(name, policy):
    with reference_x64():
        want = ref_api.solve(INSTANCES[name](ref_core),
                             policy=policy).to_schedule()
    got = solve(INSTANCES[name](core), policy=policy,
                device="cpu").to_schedule()
    assert got.summary() == want.summary()
    np.testing.assert_array_equal(got.counts(), want.counts())
    assert got.counts().dtype == want.counts().dtype


def test_summary_of_a_schedule_without_lp_bound():
    """`lp_accuracy` None prints as None, as in the reference."""
    inst, rinst = core.paper_instance(6, T=1.0), ref_core.paper_instance(
        6, T=1.0)
    a = np.array([0, 1, 2, 2, 1, 0])
    got = types.Schedule(a, inst, status="fallback", solver="x")
    want = ref_types.Schedule(a, rinst, status="fallback", solver="x")
    assert got.summary() == want.summary()
    assert "LP bound None" in got.summary()


def test_instance_es_index_p_and_alias():
    inst = core.random_instance(7, 3, T=1.0, seed=2)
    rinst = ref_core.random_instance(7, 3, T=1.0, seed=2)
    assert types.ES == ref_types.ES == -1
    assert inst.es_index == rinst.es_index == 3
    for j in range(7):
        for i in range(4):
            assert inst.p(j, i) == rinst.p(j, i)
    pr = problem.Problem.from_instance(inst)
    rpr = ref_problem.Problem.from_instance(rinst)
    assert pr.es_index == rpr.es_index == 3


def test_core_exports_equal_the_reference_but_by_decision():
    ref_all, port_all = set(ref_core.__all__), set(core.__all__)
    assert ref_all - port_all == KEPT_AS_MODULES
    assert port_all - ref_all == PORT_ONLY
    for n in core.__all__:
        assert hasattr(core, n), n
    for n in KEPT_AS_MODULES:                 # still importable, as modules
        assert getattr(core, n).__name__ == f"repro_torch.core.{n}"


def test_serving_and_data_exports():
    hi = {"HIModel", "HILearnerState", "arm_grid", "sample_confidence",
          "presample_stream", "hi_period"}
    assert hi <= set(ref_serving.__all__) and hi <= set(serving.__all__)
    for n in hi:
        assert getattr(serving, n) is getattr(core, n)
    assert set(ref_serving.__all__) <= set(serving.__all__)
    assert set(serving.__all__) - set(ref_serving.__all__) == {
        "EXEC_STATUS_NAMES", "hi"}
    assert data.__all__ == ref_data.__all__
    for n in data.__all__:
        assert hasattr(data, n)


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)
            if f.default is not dataclasses.MISSING}


@pytest.mark.parametrize("port_cls, ref_cls", [
    (lp.BatchLPResult, ref_lp.BatchLPResult),
    (executor.ExecutionReport, ref_executor.ExecutionReport),
    (runtime.PeriodStats, ref_runtime.PeriodStats),
], ids=["BatchLPResult", "ExecutionReport", "PeriodStats"])
def test_dataclass_fields_and_defaults_equal_the_reference(port_cls,
                                                           ref_cls):
    assert [f.name for f in dataclasses.fields(port_cls)] == \
        [f.name for f in dataclasses.fields(ref_cls)]
    assert _defaults(port_cls) == _defaults(ref_cls)


def test_defaults_behave_as_the_reference():
    r = lp.BatchLPResult(x=np.zeros((2, 3)), fun=np.zeros(2),
                         status=np.zeros(2, int), niter=np.ones(2, int),
                         basis=np.zeros((2, 1), int))
    assert r.warm is None and r[1].warm is False
    rep = executor.ExecutionReport(1.0, 0.5, 0.25, {})
    assert rep.status is None and rep.n_dropped == 0
    assert rep.replanned is False
