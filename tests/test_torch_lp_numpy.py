"""The port's NumPy LP oracle and the ``backend="numpy"`` paths against
the reference, on the CPU.

* `solve_lp(backend="numpy")`, cold and warm (an accepted basis, a
  rejected one, and a basis from a neighbouring instance), equals the
  reference's bit for bit: the same NumPy arithmetic gives the same
  status, x, objective, basis and iteration count;
* `solve_lp_batch(backend="numpy")` equals it lane by lane;
* the scalar `amr2()` equals the reference's on both of the port's
  backends;
* `solve(fleet, policy="amr2", backend="numpy")` against the batched
  torch path: accuracy within 1e-6 and every makespan within 2T (the
  parity check of the reference's `benchmarks/fleet_bench.py`).
"""
import importlib

import numpy as np
import pytest

import repro.api as RAPI
from repro.core import instances as RI
from repro.core import lp as RL
from repro.core.types import InstanceBatch as RefBatch
from repro_torch import api as PAPI
from repro_torch.core import amr2 as PA
from repro_torch.core import lp as PL
from repro_torch.core.types import InstanceBatch, OffloadInstance
from repro_torch.serving.fleet import make_fleet
from test_torch_parity_util import reference_x64

RA = importlib.import_module("repro.core.amr2")
V5E = dict(es_peak_flops=197e12, es_hbm_bw=819e9)


def _port(inst):
    return OffloadInstance(p_ed=inst.p_ed, p_es=inst.p_es, acc=inst.acc,
                           T=inst.T)


def _same(got, want):
    assert got.status == want.status and got.niter == want.niter
    assert got.warm == want.warm
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.basis, want.basis)
    assert got.fun == want.fun


def _lp_instances(seed):
    return [RI.random_instance(n, m, T=T, seed=seed + k)
            for k, (n, m, T) in enumerate(((4, 2, 0.4), (8, 3, 0.6),
                                           (12, 2, 1.2), (6, 3, 1e-3)))]


@pytest.mark.parametrize("seed", [0, 10, 20])
def test_solve_lp_numpy_equals_reference_cold_and_warm(seed):
    statuses = set()
    for inst in _lp_instances(seed):
        args = RA.build_lp_arrays(inst)
        want = RL.solve_lp(*args, backend="numpy")
        got = PL.solve_lp(*args, backend="numpy")
        _same(got, want)
        statuses.add(got.status)
        # warm from its own optimum, from a neighbour's, and a stale basis
        near = RA.build_lp_arrays(RI.random_instance(
            inst.n, inst.m, T=inst.T * 1.1, seed=seed + 99))
        stale = np.full_like(want.basis, -1)
        for wb, a in ((want.basis, args), (want.basis, near),
                      (stale, args)):
            w = RL.solve_lp(*a, backend="numpy", warm_basis=wb)
            g = PL.solve_lp(*a, backend="numpy", warm_basis=wb)
            _same(g, w)
    assert statuses >= {RL.OPTIMAL, RL.INFEASIBLE}
    # an iteration cap: the same status and counter
    args = RA.build_lp_arrays(_lp_instances(seed)[1])
    _same(PL.solve_lp(*args, backend="numpy", maxiter=3),
          RL.solve_lp(*args, backend="numpy", maxiter=3))


@pytest.mark.parametrize("seed", [1, 2])
def test_solve_lp_batch_numpy_equals_reference_lane_by_lane(seed):
    insts = [RI.random_instance(6, 2, T=0.3 + 0.1 * k, seed=seed * 50 + k)
             for k in range(6)]
    batch = InstanceBatch.stack([_port(i) for i in insts])
    c, A_ub, b_ub, A_eq, b_eq = PA.build_lp_arrays_batch(batch)
    cold = PL.solve_lp_batch(c, A_ub, b_ub, A_eq, b_eq, backend="numpy")
    warm = cold.basis.copy()
    warm[::2] = -1
    hot = PL.solve_lp_batch(c, A_ub, b_ub, A_eq, b_eq, backend="numpy",
                            warm_basis=warm)
    for b, inst in enumerate(insts):
        args = RA.build_lp_arrays(inst)
        _same(cold[b], RL.solve_lp(*args, backend="numpy"))
        wb = None if b % 2 == 0 else warm[b]
        _same(hot[b], RL.solve_lp(*args, backend="numpy", warm_basis=wb))
    assert hot.warm.tolist() == [b % 2 == 1 for b in range(6)]
    # the batched torch path agrees on statuses and optima
    res = PL.solve_lp_batch(c, A_ub, b_ub, A_eq, b_eq, device="cpu")
    np.testing.assert_array_equal(res.status, cold.status)
    np.testing.assert_allclose(res.fun, cold.fun, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="'torch'"):
        PL.solve_lp_batch(c, A_ub, b_ub, A_eq, b_eq, backend="jax")


@pytest.mark.parametrize("seed", [0, 5])
def test_scalar_amr2_equals_reference(seed):
    for inst in _lp_instances(seed) + [RI.paper_instance(10, 0.8, seed)]:
        want = RA.amr2(inst)                       # the NumPy oracle
        for backend in ("numpy", "torch"):
            got = PA.amr2(_port(inst), backend=backend, device="cpu")
            np.testing.assert_array_equal(got.assignment, want.assignment)
            assert got.status == want.status
            assert got.n_fractional == want.n_fractional
            if want.lp_accuracy is None:
                assert got.lp_accuracy is None
            else:
                assert abs(got.lp_accuracy - want.lp_accuracy) <= 1e-9
    insts = [_port(i) for i in _lp_instances(seed)[:1]] * 3
    scheds = PA.amr2_batch(InstanceBatch.stack(insts), device="cpu")
    assert [s.status for s in scheds] == [RA.amr2(_lp_instances(seed)[0])
                                          .status] * 3


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_numpy_oracle_against_the_batched_path(seed):
    """The reference bench's parity section on the port: 48 devices of 12
    jobs from `make_fleet` profiles, T = 1.2 s."""
    rng = np.random.default_rng(seed)
    specs = make_fleet(48, seed=seed, straggler_frac=0.0, outage_frac=0.0,
                       **V5E)
    T = 1.2
    insts = [s.profile.instance(rng.choice(s.profile.classes, size=12), T)
             for s in specs]
    fp = PAPI.FleetProblem.from_batch(InstanceBatch.stack(insts))
    sol = PAPI.solve(fp, policy="amr2", device="cpu")
    oracle = PAPI.solve(fp, policy="amr2", backend="numpy", device="cpu")
    assert np.abs(sol.accuracy - oracle.accuracy).max() <= 1e-6
    assert float(np.max(sol.makespan)) <= 2 * T + 1e-9
    assert float(np.max(oracle.makespan)) <= 2 * T + 1e-9
    # and the port's oracle is the reference's, device by device
    want = RAPI.solve(RAPI.FleetProblem(p_ed=fp.p_ed, p_es=fp.p_es,
                                        acc=fp.acc, T=fp.T,
                                        real_mask=fp.real_mask),
                      policy="amr2", backend="numpy")
    np.testing.assert_array_equal(oracle.assignment, want.assignment)
    np.testing.assert_array_equal(oracle.status, want.status)
    np.testing.assert_array_equal(oracle.basis, want.basis)
    # the dual: the batched path equals its NumPy oracle
    dual = PAPI.solve(fp, policy="dual", device="cpu")
    dual_np = PAPI.solve(fp, policy="dual", backend="numpy", device="cpu")
    np.testing.assert_array_equal(dual.assignment, dual_np.assignment)
    with reference_x64():
        ref_dual = RAPI.solve(RAPI.FleetProblem.from_batch(RefBatch(
            p_ed=fp.p_ed, p_es=fp.p_es, acc=fp.acc, T=fp.T)), policy="dual")
    np.testing.assert_array_equal(dual.assignment, ref_dual.assignment)
