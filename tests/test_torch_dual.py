"""The port's dual scheduler (`repro_torch.core.dual`) and everything
behind ``policy="dual"`` against `repro.core.dual`, on the CPU.

* the NumPy oracle `dual_schedule` against the reference's, on
  `paper_instance` and `random_instance`s;
* the batched tensor path (`dual_schedule_batch_arrays`, `dual_one_batch`)
  against the reference's batched dual and against the NumPy oracle, at n
  in {1, 5, 12, 16}, with phantom padding;
* the fallback status at a tiny T, first-index tie-breaks, the front door
  (`solve` on a `Problem` and a `FleetProblem`, both backends) and
  `ServingRuntime(policy="dual")`.

Bar: assignments and statuses exact.  The tensor path sums each job's
prefix load in another order than the oracle's cumulative sum; a decision
can differ only where a prefix load lands within rounding of ``T +
1e-12``, which none of these instances does.
"""
import dataclasses

import numpy as np
import pytest

import repro.api as RAPI
from repro.core import dual as RD
from repro.core import instances as RI
from repro.core.types import InstanceBatch as RefBatch
from repro.core.types import OffloadInstance as RefInstance
from repro.serving import executor as ref_executor
from repro.serving import profile as ref_profile
from repro.serving import runtime as ref_runtime
from repro_torch import api as PAPI
from repro_torch import convert
from repro_torch.core import dual as PD
from repro_torch.core.types import InstanceBatch, OffloadInstance
from repro_torch.serving import executor, profile, runtime
from test_torch_parity_util import reference_x64


def _port(inst):
    return OffloadInstance(p_ed=inst.p_ed, p_es=inst.p_es, acc=inst.acc,
                           T=inst.T)


def _instances(n, seed, count=24):
    """Random instances of n jobs on 3 local models, budgets from tight to
    loose, so both the feasible-at-0 exit and the bisection run."""
    return [RI.random_instance(n, 3, T=0.2 + 0.15 * (s % 6), seed=seed + s)
            for s in range(count)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dual_schedule_matches_reference_oracle(seed):
    insts = [RI.paper_instance(n, T, seed=seed)
             for n, T in ((6, 0.5), (12, 0.9), (20, 1.6))]
    insts += _instances(9, 100 * seed)
    statuses = set()
    for inst in insts:
        want = RD.dual_schedule(inst)
        got = PD.dual_schedule(_port(inst))
        np.testing.assert_array_equal(got.assignment, want.assignment)
        assert got.status == want.status and got.solver == "dual"
        statuses.add(got.status)
    assert "ok" in statuses


@pytest.mark.parametrize("n", [1, 5, 12, 16])
@pytest.mark.parametrize("seed", [0, 7])
def test_batched_dual_matches_reference_batch_and_oracle(n, seed):
    insts = _instances(n, 1000 * seed + n, count=40)
    ref = RefBatch.stack(insts)
    # phantom padding on every fourth lane (p = 0 slots), as the fleet has
    if n > 1:
        p_ed, p_es = ref.p_ed.copy(), ref.p_es.copy()
        p_ed[::4, -1], p_es[::4, -1] = 0.0, 0.0
        ref = RefBatch(p_ed=p_ed, p_es=p_es, acc=ref.acc, T=ref.T)
    with reference_x64():
        want_a, want_s = RD.dual_schedule_batch_arrays(ref)
    port = InstanceBatch(p_ed=ref.p_ed, p_es=ref.p_es, acc=ref.acc, T=ref.T)
    got_a, got_s = PD.dual_schedule_batch_arrays(port, device="cpu")
    assert got_a.dtype == got_s.dtype == np.int64
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_s, want_s)
    for b in range(len(port)):
        oracle = PD.dual_schedule(port[b])
        np.testing.assert_array_equal(got_a[b], oracle.assignment)
        assert got_s[b] == (0 if oracle.status == "ok" else 1)
    # the bisection ran on some lanes (lam = 0 was infeasible there)
    loose = [PD._ed_load(port[b], PD._recover(port[b], 0.0)) <= port.T[b]
             for b in range(len(port))]
    assert not all(loose)
    scheds = PD.dual_schedule_batch(port, device="cpu")
    assert [s.status for s in scheds] == \
        ["ok" if s == 0 else "fallback" for s in got_s]


@pytest.mark.parametrize("n", [3, 8])
def test_tiny_budget_falls_back_to_the_fastest_models(n):
    inst = RI.random_instance(n, 3, T=1e-4, seed=n)
    want = RD.dual_schedule(inst)
    got = PD.dual_schedule(_port(inst))
    assert want.status == got.status == "fallback"
    np.testing.assert_array_equal(got.assignment, np.argmin(inst.p_ed, 1))
    np.testing.assert_array_equal(got.assignment, want.assignment)
    a, s = PD.dual_schedule_batch_arrays(
        InstanceBatch.stack([_port(inst)]), device="cpu")
    np.testing.assert_array_equal(a[0], want.assignment)
    assert s.tolist() == [1]


@pytest.mark.parametrize("T", [0.05, 0.5, 5.0])
def test_tied_scores_take_the_first_index(T):
    """Two local models of equal accuracy and equal times tie every
    argmax and argmin; identical jobs tie every density.  Both packages
    take the first index."""
    n = 6
    p_ed = np.tile([[0.1, 0.1, 0.3]], (n, 1))
    inst = RefInstance(p_ed=p_ed, p_es=np.full(n, 0.2),
                       acc=np.array([0.5, 0.5, 0.7, 0.9]), T=T)
    want = RD.dual_schedule(inst)
    got = PD.dual_schedule(_port(inst))
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.status == want.status
    with reference_x64():
        want_b, _ = RD.dual_schedule_batch_arrays(RefBatch.stack([inst]))
    got_b, _ = PD.dual_schedule_batch_arrays(
        InstanceBatch.stack([_port(inst)]), device="cpu")
    np.testing.assert_array_equal(got_b, want_b)
    np.testing.assert_array_equal(got_b[0], got.assignment)
    # offloads go to the lowest job indices first; no job takes model 1
    off = np.nonzero(got.assignment == 3)[0]
    np.testing.assert_array_equal(off, np.arange(len(off)))
    assert not (got.assignment == 1).any()


def _fleet(B, n=8, seed=0):
    insts = _instances(n, seed, count=B)
    p_ed = np.stack([i.p_ed for i in insts])
    p_es = np.stack([i.p_es for i in insts])
    mask = np.ones((B, n), bool)
    mask[::3, -2:] = False
    p_ed[~mask], p_es[~mask] = 0.0, 0.0
    return RAPI.FleetProblem(p_ed=p_ed, p_es=p_es,
                             acc=np.stack([i.acc for i in insts]),
                             T=np.array([i.T for i in insts]),
                             real_mask=mask)


@pytest.mark.parametrize("seed", [0, 3])
def test_front_door_dual_matches_reference(seed):
    fp = _fleet(12, seed=seed)
    pfp = convert.fleet_problem_from_numpy(fp)
    with reference_x64():
        want = RAPI.solve(fp, policy="dual")
        want_es = RAPI.solve(fp, policy="dual", es_disabled=True)
    want_np = RAPI.solve(fp, policy="dual", backend="numpy")
    for w, kw in ((want, {}), (want_es, dict(es_disabled=True)),
                  (want_np, dict(backend="numpy"))):
        got = PAPI.solve(pfp, policy="dual", device="cpu", **kw)
        np.testing.assert_array_equal(got.assignment, w.assignment)
        np.testing.assert_array_equal(got.status, w.status)
        assert list(got.solver) == list(w.solver) == ["dual"] * len(fp)
    for b in (0, 4):
        p = fp[b]
        pp = PAPI.Problem(p.p_ed, p.p_es, p.acc, p.T)
        want = RAPI.solve(p, policy="dual")           # the NumPy oracle
        for backend in ("torch", "numpy"):
            got = PAPI.solve(pp, policy="dual", backend=backend,
                             device="cpu")
            np.testing.assert_array_equal(got.assignment, want.assignment)
            assert int(got.status) == int(want.status)
            assert got.solver == "dual"
    many = PAPI.solve_many([PAPI.Problem(p.p_ed, p.p_es, p.acc, p.T)
                            for p in (fp[1], fp[2])], policy="dual",
                           device="cpu")
    for got, b in zip(many, (1, 2)):
        np.testing.assert_array_equal(
            got.assignment, RAPI.solve(fp[b], policy="dual").assignment)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def advance(self, seconds):
        self.t += seconds


def _ladder(clock, costs, es_cost):
    def ed(i):
        def apply(jobs):
            clock.advance(costs[i] * len(jobs))
            return [(i, int(j[0])) for j in jobs]
        return apply

    def es(jobs):
        clock.advance(es_cost * len(jobs))
        return [("es", int(j[0])) for j in jobs]

    return [ed(i) for i in range(len(costs))], es


@pytest.mark.parametrize("seed", [0, 1])
def test_serving_runtime_dual_matches_reference(monkeypatch, seed):
    """Four periods of the dual runtime on heterogeneous jobs with fake
    clocks: normal, ES outage (replan), a 3x ED straggler, after it."""
    ref_clock, port_clock = _Clock(), _Clock()
    for mod in (ref_executor, ref_profile):
        monkeypatch.setattr(mod, "time", ref_clock)
    for mod in (executor, profile):
        monkeypatch.setattr(mod, "time", port_clock)
    rng = np.random.default_rng(seed)
    n, T = 10, 0.12
    p0 = rng.uniform(0.005, 0.02, n)
    prof = ref_profile.TierProfile(
        name="ladder", p_ed=np.stack([p0, p0 * rng.uniform(1.5, 2.5, n)], 1),
        p_es=rng.uniform(0.01, 0.03, n), acc=np.array([0.4, 0.6, 0.9]),
        classes=list(range(n)))
    ref_rt = ref_runtime.ServingRuntime(
        prof, *_ladder(ref_clock, [0.01, 0.02], 0.03), T=T, policy="dual")
    rt = runtime.ServingRuntime(
        profile.TierProfile(name=prof.name, p_ed=prof.p_ed.copy(),
                            p_es=prof.p_es.copy(), acc=prof.acc.copy(),
                            classes=list(prof.classes)),
        *_ladder(port_clock, [0.01, 0.02], 0.03), T=T, policy="dual",
        device="cpu")
    for period in range(4):
        if period == 2:
            ref_rt.apply_ed = _ladder(ref_clock, [0.03, 0.06], 0.03)[0]
            rt.apply_ed = _ladder(port_clock, [0.03, 0.06], 0.03)[0]
        jobs = [rng.integers(0, 100, 8) for _ in range(n)]
        with reference_x64():
            want = ref_rt.run_period(jobs, np.arange(n),
                                     es_fail=(period == 1))
        got = rt.run_period(jobs, np.arange(n), es_fail=(period == 1))
        w, g = dataclasses.asdict(want), dataclasses.asdict(got)
        w.pop("plan_seconds"), g.pop("plan_seconds")
        assert g == w, period
        np.testing.assert_array_equal(rt.profile.p_ed, ref_rt.profile.p_ed)
    assert [s.policy for s in rt.history] == ["dual"] * 4
    assert rt.history[1].replanned
