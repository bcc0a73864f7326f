"""AMR^2's LP build and rounding (`repro_torch.core.amr2`) against the
reference (`repro.core.amr2`), plus the paper's 2T makespan guarantee.

The rounding is held on identical inputs — the reference's own LP
relaxation, handed to both sides as NumPy — over every branch of the case
tree: integral rows, one and two fractional jobs, more than two (the
numeric fallback), infeasible and unsolved lanes.  Both of the port's
roundings are held: the engine's tensor path (`round_relaxation_torch`
against `round_relaxation_jnp`) and the front door's NumPy path
(`round_relaxation_batch`, the scalar `round_relaxation`, `solve_sub_ilp`
and `algorithm2_case_tree` against the reference's), and the host chain
`amr2_batch_arrays`.  Tolerances: the LP arrays and every rounding output
exact; the LP bound to 1e-9.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.amr2 import build_lp_arrays_jnp, round_relaxation_jnp
from repro.core import lp as jlp
from repro.core.types import InstanceBatch as RefBatch
from repro.core.types import OffloadInstance as RefInstance
from repro_torch.core import amr2, lp
from repro_torch.core.types import InstanceBatch, OffloadInstance
from test_torch_parity_util import reference_x64, to_numpy

# `repro.core` re-exports the function `amr2` under the module's name
ramr2 = importlib.import_module("repro.core.amr2")

B, N, M = 32, 8, 2


def _batch(seed):
    rng = np.random.default_rng(seed)
    p_ed = np.sort(rng.uniform(0.02, 0.4, (B, N, M)), axis=2)
    p_es = rng.uniform(0.1, 0.9, (B, N))
    acc = np.sort(rng.uniform(0.3, 0.95, (B, M + 1)), axis=1)
    T = rng.uniform(0.5, 1.5, B)
    return p_ed, p_es, acc, T


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def test_lp_arrays_match_reference():
    data = _batch(0)
    got = amr2.build_lp_arrays_torch(*map(_t, data))
    with reference_x64():
        want = build_lp_arrays_jnp(*map(jnp.asarray, data))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


def _reference_relaxation(data):
    with reference_x64():
        A, b, c = build_lp_arrays_jnp(*map(jnp.asarray, data))
        x, _f, status, *_ = jax.jit(
            lambda A, b, c: jlp.simplex_batch_core(A, b, c, None,
                                                   nv=N * (M + 1),
                                                   maxiter=1024))(A, b, c)
    return (np.array(x).reshape(B, N, M + 1), np.array(status))


def _round_both(data, xbar, status):
    got = amr2.round_relaxation_torch(*map(_t, data), _t(xbar), _t(status))
    with reference_x64():
        want = jax.jit(round_relaxation_jnp)(
            *map(jnp.asarray, data), jnp.asarray(xbar), jnp.asarray(status))
    for g, w, name in zip(got, want, ("assignment", "status", "n_frac")):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w), name)
    return [to_numpy(g) for g in got]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rounding_matches_reference_on_lp_relaxations(seed):
    data = _batch(seed)
    xbar, status = _reference_relaxation(data)
    _assign, _sched, n_frac = _round_both(data, xbar, status)
    assert (n_frac > 0).any() and (n_frac == 0).any()


def test_rounding_matches_reference_on_every_branch():
    data = _batch(4)
    xbar, status = _reference_relaxation(data)
    rng = np.random.default_rng(4)
    # more than two fractional rows: the numeric fallback, with ties in
    # fractionality resolved by the stable sort
    many = np.flatnonzero(status == jlp.OPTIMAL)[:8]
    for b in many:
        k = 3 + b % 3
        rows = rng.choice(N, k, replace=False)
        xbar[b, rows] = 0.0
        xbar[b, rows, 0] = 0.5 if b % 2 else rng.uniform(0.3, 0.7)
        xbar[b, rows, M] = 1.0 - xbar[b, rows, 0]
    rest = np.setdiff1d(np.arange(B), many)
    status[rest[:4]] = jlp.INFEASIBLE
    status[rest[4:6]] = jlp.ITERATION_LIMIT
    status[rest[6]] = jlp.UNBOUNDED
    _assign, sched, _n_frac = _round_both(data, xbar, status)
    assert (sched[many] == amr2.ST_FALLBACK).all()
    assert (sched[rest[:4]] == amr2.ST_INFEASIBLE).all()
    assert (sched[rest[4:7]] == amr2.ST_UNSOLVED).all()


@pytest.mark.parametrize("method", ["tableau", "revised"])
def test_port_amr2_keeps_makespan_within_2T(method):
    """Theorem 1: for a feasible P the rounded schedule's makespan on each
    tier is at most 2T."""
    data = _batch(5)
    p_ed, p_es, acc, T = map(_t, data)
    A, b, c = amr2.build_lp_arrays_torch(p_ed, p_es, acc, T)
    x, _f, status, *_ = lp.simplex_batch_core(A, b, c, None, nv=N * (M + 1),
                                              maxiter=1024, method=method)
    assign, sched, _nf = amr2.round_relaxation_torch(
        p_ed, p_es, acc, T, x.reshape(B, N, M + 1), status)
    ok = (status == lp.OPTIMAL) & (sched != amr2.ST_FALLBACK)
    assert ok.sum() > B // 2
    on_ed = assign < M
    ed = torch.where(on_ed, torch.gather(p_ed, 2, assign.clamp(0, M - 1)
                                         .long()[..., None])[..., 0],
                     0.0).sum(1)
    es = torch.where(assign == M, p_es, 0.0).sum(1)
    assert (ed[ok] <= 2 * T[ok] + 1e-12).all()
    assert (es[ok] <= 2 * T[ok] + 1e-12).all()


def _every_branch():
    """The LP relaxations of `_batch(4)` with every rounding branch
    forced (see the test above)."""
    data = _batch(4)
    xbar, status = _reference_relaxation(data)
    rng = np.random.default_rng(4)
    many = np.flatnonzero(status == jlp.OPTIMAL)[:8]
    for b in many:
        rows = rng.choice(N, 3 + b % 3, replace=False)
        xbar[b, rows] = 0.0
        xbar[b, rows, 0] = rng.uniform(0.3, 0.7)
        xbar[b, rows, M] = 1.0 - xbar[b, rows, 0]
    rest = np.setdiff1d(np.arange(B), many)
    status[rest[:4]] = jlp.INFEASIBLE
    status[rest[4:6]] = jlp.ITERATION_LIMIT
    status[rest[6]] = jlp.UNBOUNDED
    return data, xbar, status


def test_numpy_rounding_matches_reference_on_every_branch():
    data, xbar, status = _every_branch()
    want = ramr2.round_relaxation_batch(RefBatch(*data), xbar, status,
                                        on_error="mark")
    got = amr2.round_relaxation_batch(InstanceBatch(*data), xbar, status,
                                      on_error="mark")
    for g, w, name in zip(got, want, ("assignment", "status", "n_frac")):
        np.testing.assert_array_equal(g, w, name)
    assert set(got[1].tolist()) == {amr2.ST_OK, amr2.ST_FALLBACK,
                                    amr2.ST_INFEASIBLE, amr2.ST_UNSOLVED}
    with pytest.raises(RuntimeError, match="did not converge"):
        amr2.round_relaxation_batch(InstanceBatch(*data), xbar, status)


def test_two_job_sub_ilp_and_case_tree_match_reference():
    rng = np.random.default_rng(6)
    n_none = 0
    for _ in range(40):
        T = rng.uniform(0.2, 1.0)
        p_ed = np.sort(rng.uniform(0.05, 0.8, (2, M)), axis=1)
        p_es = rng.uniform(0.05, 1.2, 2)
        acc = np.sort(rng.uniform(0.3, 0.95, M + 1))
        ref = RefInstance(p_ed, p_es, acc, T)
        port = OffloadInstance(p_ed, p_es, acc, T)
        want = ramr2.solve_sub_ilp(ref, 0, 1)
        assert amr2.solve_sub_ilp(port, 0, 1) == want
        assert amr2.algorithm2_case_tree(port, 0, 1) == \
            ramr2.algorithm2_case_tree(ref, 0, 1)
        n_none += want is None
    assert 0 < n_none < 40


@pytest.mark.parametrize("warm", [False, True])
def test_amr2_batch_arrays_matches_reference(warm):
    data = _batch(7)
    basis = None
    if warm:
        with reference_x64():
            basis = ramr2.amr2_batch_arrays(RefBatch(*data))[4].copy()
        basis[::3] = -1
    with reference_x64():
        want = ramr2.amr2_batch_arrays(RefBatch(*data), warm_basis=basis)
    got = amr2.amr2_batch_arrays(InstanceBatch(*data), warm_basis=basis,
                                 device="cpu")
    for k, name in enumerate(("assignment", "status", "n_frac")):
        np.testing.assert_array_equal(got[k], want[k], name)
    ok = got[1] == amr2.ST_OK
    np.testing.assert_allclose(got[3][ok], want[3][ok], atol=1e-9, rtol=0)
    np.testing.assert_array_equal(got[4], want[4])
