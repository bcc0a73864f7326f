"""The port's AMDP (`repro_torch.core.amdp`) against the reference
(`repro.core.amdp`), on the CPU through the CCKP kernel's plain version:

* `solve_cckp`, `amdp`, `amdp_batch` and `amdp_hetero_comm`, with
  infeasible instances, instances whose jobs all fit the ES (n_l = 0),
  batches mixing budgets and job counts, and stripped ES-disabled
  instances;
* the port's `brute_force` and optimality at n = 7, as
  `examples/amdp_identical.py` checks it.

Tolerance: none.  Assignments, statuses and counts exact; the CCKP value
is the same float32.
"""
import importlib

import numpy as np
import pytest

from repro.core import instances as ref_instances
from repro.core.oracle import brute_force as ref_brute_force
from repro.core.types import OffloadInstance as RefInstance
from repro_torch.core import amdp as PA
from repro_torch.core.oracle import brute_force
from repro_torch.core.problem import ES_DISABLED_SENTINEL
from repro_torch.core.types import OffloadInstance

# `repro.core` re-exports the function `amdp` under the module's name
RA = importlib.import_module("repro.core.amdp")


def _pair(inst):
    """The same instance for the reference and the port."""
    return (RefInstance(inst.p_ed, inst.p_es, inst.acc, inst.T),
            OffloadInstance(inst.p_ed, inst.p_es, inst.acc, inst.T))


def _instances():
    """Identical-job instances: feasible, infeasible (a budget too small
    for any local model), all-on-the-ES (n_l = 0), one local model, three
    local models, and a stripped ES-disabled instance."""
    ident = ref_instances.identical_instance
    out = [ident(12, 2, 1.2, seed=0), ident(7, 3, 0.5, seed=1),
           ident(20, 2, 2.0, seed=2), ident(5, 1, 0.3, seed=3),
           ident(12, 2, 0.004, seed=4)]                   # infeasible
    fits = ident(4, 2, 5.0, seed=5)
    out.append(RefInstance(fits.p_ed, np.full(4, 0.2), fits.acc, 5.0))
    crip = ident(9, 2, 0.8, seed=6)
    out.append(RefInstance(crip.p_ed, np.full(9, ES_DISABLED_SENTINEL),
                           crip.acc, 0.8))
    return out


def _same_schedule(want, got):
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.status == want.status
    assert got.solver == want.solver


@pytest.mark.parametrize("k", range(7))
def test_amdp_matches_reference(k):
    ref_inst, inst = _pair(_instances()[k])
    _same_schedule(RA.amdp(ref_inst), PA.amdp(inst, device="cpu"))


def test_instance_set_covers_every_branch():
    statuses = [PA.amdp(_pair(i)[1], device="cpu").status
                for i in _instances()]
    assert "infeasible" in statuses and "ok" in statuses
    fits = PA.amdp(_pair(_instances()[5])[1], device="cpu")
    assert (fits.assignment == 2).all()                    # n_l == 0


def test_amdp_batch_mixed_budgets_and_job_counts():
    insts = _instances()
    rng = np.random.default_rng(3)
    for s in range(12):                    # more budgets and job counts
        insts.append(ref_instances.identical_instance(
            int(rng.integers(1, 16)), 2, float(rng.uniform(0.05, 2.5)),
            seed=100 + s))
    want = RA.amdp_batch([_pair(i)[0] for i in insts])
    got = PA.amdp_batch([_pair(i)[1] for i in insts], device="cpu")
    for w, g in zip(want, got):
        _same_schedule(w, g)


@pytest.mark.parametrize("seed", range(4))
def test_solve_cckp_matches_reference(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 4))
    p = rng.integers(0, 40, m)
    a = np.sort(rng.uniform(0.3, 0.9, m))
    T_int, n_l = int(rng.integers(5, 200)), int(rng.integers(0, 12))
    want_counts, want_val = RA.solve_cckp(p, a, T_int, n_l)
    got_counts, got_val = PA.solve_cckp(p, a, T_int, n_l, device="cpu")
    assert got_val == want_val
    if want_counts is None:
        assert got_counts is None
    else:
        np.testing.assert_array_equal(got_counts, want_counts)


def test_solve_cckp_infeasible():
    p, a = np.array([30, 50]), np.array([0.4, 0.6])
    assert RA.solve_cckp(p, a, 20, 3)[0] is None
    assert PA.solve_cckp(p, a, 20, 3, device="cpu") == (None, -np.inf)


@pytest.mark.parametrize("seed", range(3))
def test_amdp_hetero_comm_matches_reference(seed):
    rng = np.random.default_rng(seed)
    p_ed = np.array([0.010, 0.045])
    acc = np.array([0.395, 0.559, 0.771])
    comm = rng.uniform(0.05, 0.6, 25)
    T = float(rng.uniform(0.2, 3.0))
    _same_schedule(RA.amdp_hetero_comm(p_ed, 0.3, comm, acc, T),
                   PA.amdp_hetero_comm(p_ed, 0.3, comm, acc, T,
                                       device="cpu"))


def test_amdp_is_optimal_against_brute_force():
    """n = 7 identical jobs: the DP's accuracy equals the exhaustive
    optimum, which equals the reference oracle's."""
    p_ed = np.tile([0.010, 0.045], (7, 1))
    inst = OffloadInstance(p_ed=p_ed, p_es=np.full(7, 0.35),
                           acc=np.array([0.395, 0.559, 0.771]), T=1.0)
    opt = brute_force(inst)
    ref_opt = ref_brute_force(RefInstance(inst.p_ed, inst.p_es, inst.acc,
                                          inst.T))
    np.testing.assert_array_equal(opt.assignment, ref_opt.assignment)
    sched = PA.amdp(inst, device="cpu")
    assert sched.violation == 0.0
    assert sched.total_accuracy == pytest.approx(opt.total_accuracy,
                                                 abs=1e-12)


def test_amdp_rejects_heterogeneous_jobs():
    inst = OffloadInstance(p_ed=[[0.1, 0.2], [0.1, 0.3]], p_es=[0.5, 0.5],
                           acc=[0.4, 0.6, 0.8], T=1.0)
    with pytest.raises(ValueError, match="identical"):
        PA.amdp(inst, device="cpu")
    with pytest.raises(ValueError, match="identical"):
        PA.amdp_batch([inst], device="cpu")


def test_amdp_batch_runs_one_dp_call_per_model_count(monkeypatch):
    """`amdp_batch` hands all m models of a model-count group to one
    `models_dp` call (one kernel launch on the card) and its schedules
    still equal the reference's, for groups of m = 1, 2 and 3."""
    calls = []
    real = PA.cckp_ops.models_dp

    def spy(y, p, a, n_steps):
        calls.append((tuple(y.shape), tuple(p.shape), n_steps))
        return real(y, p, a, n_steps)

    monkeypatch.setattr(PA.cckp_ops, "models_dp", spy)
    insts = _instances()
    want = RA.amdp_batch([_pair(i)[0] for i in insts])
    got = PA.amdp_batch([_pair(i)[1] for i in insts], device="cpu")
    for w, g in zip(want, got):
        _same_schedule(w, g)
    ms = sorted(p[1] for _y, p, _n in calls)
    assert ms == [1, 2, 3]
    for y_shape, p_shape, n_steps in calls:
        assert y_shape[0] == p_shape[0] and n_steps == y_shape[2]
