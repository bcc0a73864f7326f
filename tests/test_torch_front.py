"""The port's front door (`repro_torch.api.solve` / `solve_many`) against
the reference's (`repro.api`), on the CPU.

Fleets mix `identical_instance` rows with heterogeneous
`random_instance` rows and phantom padding, so ``policy="auto"`` splits
them between AMDP and AMR^2.  Both packages start from the same arrays
(`repro_torch.convert.fleet_problem_from_numpy`).

Bar: ``assignment``, ``status``, the ``solver`` tags and ``n_fractional``
exact; ``lp_accuracy`` to 1e-9 (NaN where there is no bound); ``basis``
exact (the reference's own tableau-vs-revised bar — label sets — would
apply where ROADMAP §3 item 2's cold-path ties bite; these fleets do not
hit one).
"""
import dataclasses

import numpy as np
import pytest

import repro.api as RAPI
from repro.core import instances as ref_instances
from repro_torch import api as PAPI
from repro_torch import convert
from test_torch_parity_util import reference_x64

LP_ATOL = 1e-9


def _fleet(B, n=6, m=2, seed=0, T=1.0, phantoms=(-2, -1)):
    """Reference `FleetProblem`: even rows heterogeneous, odd rows
    identical jobs, every third row with phantom padding in the slots
    ``phantoms``."""
    insts = [(ref_instances.identical_instance if b % 2 else
              ref_instances.random_instance)(n, m, T, seed=seed + b)
             for b in range(B)]
    p_ed = np.stack([i.p_ed for i in insts])
    p_es = np.stack([i.p_es for i in insts])
    mask = np.ones((B, n), bool)
    mask[::3, list(phantoms)] = False
    p_ed[~mask] = 0.0
    p_es[~mask] = 0.0
    return RAPI.FleetProblem(p_ed=p_ed, p_es=p_es,
                             acc=np.stack([i.acc for i in insts]),
                             T=np.array([i.T for i in insts]),
                             real_mask=mask)


def _assert_same(want, got):
    w, g = convert.solution_fields(want), convert.solution_fields(got)
    for f in ("assignment", "status", "solver", "n_fractional", "basis"):
        if w[f] is None:
            assert g[f] is None, f
        else:
            np.testing.assert_array_equal(g[f], w[f], f)
    if w["lp_accuracy"] is None:
        assert g["lp_accuracy"] is None
    else:
        np.testing.assert_allclose(g["lp_accuracy"], w["lp_accuracy"],
                                   rtol=0, atol=LP_ATOL, equal_nan=True)


def _both(ref_problem, port_problem=None, **kw):
    with reference_x64():
        want = RAPI.solve(ref_problem, **kw)
    if port_problem is None:
        port_problem = convert.fleet_problem_from_numpy(ref_problem)
    return want, PAPI.solve(port_problem, device="cpu", **kw)


@pytest.mark.parametrize("policy", ["auto", "amdp", "amr2"])
def test_fleet_split_matches_reference(policy):
    want, got = _both(_fleet(14, seed=3), policy=policy)
    _assert_same(want, got)
    tags = set(convert.solution_fields(got)["solver"])
    assert tags == ({"amr2"} if policy == "amr2" else {"amr2", "amdp"})


@pytest.mark.parametrize("phantoms", [(-2, -1), (0, 3)],
                         ids=["trailing", "interleaved"])
def test_es_disabled_matches_reference(phantoms):
    """Identical real jobs go to the DP on their stripped instances, and
    the plan is scattered back to their slots, wherever the phantoms
    sit."""
    want, got = _both(_fleet(12, seed=5, phantoms=phantoms),
                      es_disabled=True)
    _assert_same(want, got)
    assert set(convert.solution_fields(got)["solver"]) == {"amr2", "amdp"}
    assert (got.es_makespan == 0).all()


def test_warm_start_with_cold_rows_matches_reference():
    fp = _fleet(10, seed=8)
    with reference_x64():
        first = RAPI.solve(fp)
    warm = first.basis.copy()
    warm[1::4] = -1                       # some devices start cold
    want, got = _both(fp, warm_start=warm)
    _assert_same(want, got)


def test_single_problems_and_solve_many_match_reference():
    fleet = _fleet(6, seed=11)
    probs = [fleet[b] for b in range(6)]
    probs += [RAPI.Problem.from_instance(
        ref_instances.random_instance(4, 3, 0.8, seed=40))]
    for p in probs[:3]:
        want, got = _both(p, PAPI.Problem(p.p_ed, p.p_es, p.acc, p.T))
        _assert_same(want, got)
    with reference_x64():
        want = RAPI.solve_many(probs)
    got = PAPI.solve_many([PAPI.Problem(p.p_ed, p.p_es, p.acc, p.T)
                           for p in probs], device="cpu")
    assert len(got) == len(want)
    for w, g in zip(want, got):
        _assert_same(w, g)


def test_amdp_on_heterogeneous_single_problem_falls_back_to_amr2():
    p = _fleet(1, seed=20)[0]
    want, got = _both(p, PAPI.Problem(p.p_ed, p.p_es, p.acc, p.T),
                      policy="amdp")
    _assert_same(want, got)
    assert got.solver == "amr2"


def test_greedy_sequential_matches_reference_numpy_backend():
    fp = _fleet(8, seed=30)
    want = RAPI.solve(fp, policy="greedy", backend="numpy")
    got = PAPI.solve(convert.fleet_problem_from_numpy(fp), policy="greedy",
                     device="cpu")
    _assert_same(want, got)
    probs = [fp[b] for b in range(len(fp))]
    want_many = RAPI.solve_many(probs, policy="greedy", backend="numpy")
    got_many = PAPI.solve_many([PAPI.Problem(p.p_ed, p.p_es, p.acc, p.T)
                                for p in probs], policy="greedy",
                               device="cpu")
    for w, g in zip(want_many, got_many, strict=True):
        _assert_same(w, g)


def test_lp_bound_matches_reference():
    want, got = _both(_fleet(8, seed=31), policy="lp")
    _assert_same(want, got)


def test_strict_raises_and_lenient_warns_at_capped_maxiter():
    fp = convert.fleet_problem_from_numpy(_fleet(6, seed=2))
    with pytest.raises(RuntimeError, match="not solved to optimality"):
        PAPI.solve(fp, policy="amr2", maxiter=2, device="cpu")
    with pytest.warns(RuntimeWarning, match="not solved to optimality"):
        sol = PAPI.solve(fp, policy="amr2", maxiter=2, strict=False,
                         device="cpu")
    with reference_x64(), pytest.warns(RuntimeWarning):
        want = RAPI.solve(_fleet(6, seed=2), policy="amr2", maxiter=2,
                          strict=False)
    _assert_same(want, sol)
    assert (sol.status == PAPI.ST_UNSOLVED).any()


def test_typo_guard_and_registry():
    fp = convert.fleet_problem_from_numpy(_fleet(4, seed=1))
    with pytest.raises(TypeError, match="does not accept"):
        PAPI.solve(fp, policy="amr2", max_iter=10, device="cpu")
    with pytest.raises(TypeError, match="does not accept"):
        RAPI.solve(_fleet(4, seed=1), policy="amr2", max_iter=10)
    # dual (ROADMAP §1 item 5), routed and the HI entries (item 9) are
    # registered with the reference's flags: the registries agree
    assert PAPI.solver_names() == ["amdp", "amr2", "dual", "greedy",
                                   "hi_bandit", "hi_threshold", "lp",
                                   "routed"]
    assert PAPI.solver_names() == sorted(RAPI.solver_names())
    for name in ("dual", "routed"):
        assert (dataclasses.asdict(PAPI.solvers()[name])
                == dataclasses.asdict(RAPI.solvers()[name]))
    assert (PAPI.solve(fp, policy="dual", device="cpu").solver
            == "dual").all()
    with pytest.raises(TypeError, match="positions"):
        PAPI.solve(fp, policy="routed", device="cpu")
    for name in ("hi_threshold", "hi_bandit"):
        assert (dataclasses.asdict(PAPI.solvers()[name])
                == dataclasses.asdict(RAPI.solvers()[name]))
        with pytest.raises(TypeError, match="confidence"):
            PAPI.solve(fp, policy=name, device="cpu")
    with pytest.raises(ValueError, match="unknown solver"):
        PAPI.get_solver("simplex")
    # backend is a front-door option now: "numpy" runs the oracle, the
    # reference's "jax" is refused naming the port's "torch"
    assert (PAPI.solve(fp, policy="amr2", backend="numpy",
                       device="cpu").solver == "amr2").all()
    with pytest.raises(ValueError, match="'torch'"):
        PAPI.solve(fp, policy="amr2", backend="jax", device="cpu")
    assert "| `amdp` | yes | yes |" in PAPI.solver_table()
