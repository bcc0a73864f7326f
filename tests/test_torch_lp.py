"""The port's batched simplex (`repro_torch.core.lp`) against the reference.

`simplex_batch_core` runs for both methods on fleet LPs built from seeded
NumPy data — cold lanes, warm lanes (previous bases, some rejected, some
needing feasibility repair) and masked lanes — beside the reference's
`repro.core.lp.simplex_batch_core` (jitted, as the engine runs it) and
scipy's HiGHS objectives.  The host entry points `solve_lp_batch` and
`solve_lp` (NumPy in, NumPy out) run beside the reference's.

Tolerances: statuses and warm-accept flags exact; ``x`` and ``fun`` of
OPTIMAL lanes to atol 1e-9; scipy objectives to 1e-7 (HiGHS' own
tolerance); a warm restart from an optimal basis exact in pivots (0) and
basis; masked lanes exact in pivots (0).

Cold pivot paths are not pinned, which is the bar the reference holds its
own tableau and revised methods to: the fleet LP has reduced costs that
tie, or nearly tie, at the last bit, and which one Dantzig's rule picks
depends on how the pricing products round.  XLA's CPU code rounds them
with a fused multiply-add in its vectorized columns and without one in
the tail, by shape; PyTorch rounds them otherwise (ROADMAP §3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from repro.core import lp as jlp
from repro.core.amr2 import build_lp_arrays_jnp
from repro_torch.core import lp
from repro_torch.core.amr2 import build_lp_arrays_torch
from test_torch_parity_util import reference_x64, to_numpy

B, N, M = 24, 6, 2
NV = N * (M + 1)
MAXITER = 512


def _fleet(seed, degenerate=False):
    """A batch of fleet LPs with paper-like latencies; ``degenerate`` adds
    phantom jobs (zero latencies, like padded slots) and ES-disabled
    lanes."""
    rng = np.random.default_rng(seed)
    p_ed = np.sort(rng.uniform(0.01, 0.3, (B, N, M)), axis=2)
    p_es = rng.uniform(0.1, 0.9, (B, N))
    acc = np.sort(rng.uniform(0.3, 0.95, (B, M + 1)), axis=1)
    T = rng.uniform(0.4, 1.2, B)
    if degenerate:
        phantom = rng.uniform(size=(B, N)) < 0.15
        p_ed[phantom] = 0.0
        p_es[phantom] = 0.0
        p_es[::7] = np.where(phantom[::7], 0.0, 1e9)      # ES disabled
    return p_ed, p_es, acc, T


def _port_arrays(p_ed, p_es, acc, T):
    return build_lp_arrays_torch(*(torch.as_tensor(x)
                                   for x in (p_ed, p_es, acc, T)))


def _ref_solve(p_ed, p_es, acc, T, basis0, lane_mask, method):
    with reference_x64():
        A, b, c = build_lp_arrays_jnp(*(jnp.asarray(x)
                                        for x in (p_ed, p_es, acc, T)))
        fn = jax.jit(functools.partial(
            jlp.simplex_batch_core, nv=NV, maxiter=MAXITER, method=method))
        out = fn(A, b, c, None if basis0 is None else jnp.asarray(basis0),
                 lane_mask=None if lane_mask is None
                 else jnp.asarray(lane_mask))
        return [np.asarray(x) for x in out]


def _port_solve(p_ed, p_es, acc, T, basis0, lane_mask, method):
    A, b, c = _port_arrays(p_ed, p_es, acc, T)
    out = lp.simplex_batch_core(
        A, b, c, None if basis0 is None else torch.as_tensor(basis0),
        nv=NV, maxiter=MAXITER,
        lane_mask=None if lane_mask is None else torch.as_tensor(lane_mask),
        method=method)
    return [to_numpy(x) for x in out]


def _assert_same_optimum(got, want):
    """The reference's own bar between its tableau and revised methods
    (tests/test_lp.py): statuses exact, OPTIMAL lanes' x and objective to
    tolerance.  Cold pivot paths are not pinned: on floating-point
    Dantzig ties they differ even between the reference's two methods."""
    np.testing.assert_array_equal(got[2], want[2], "status")
    opt = want[2] == lp.OPTIMAL
    np.testing.assert_allclose(got[0][opt], want[0][opt], atol=1e-9, rtol=0)
    np.testing.assert_allclose(got[1][opt], want[1][opt], atol=1e-9, rtol=0)
    np.testing.assert_array_equal(got[5], want[5], "warm_ok")


def _assert_scipy_optimum(data, got):
    x, fun, status = got[:3]
    A, b, c = (t.numpy() for t in _port_arrays(*data))
    for k in range(B):
        res = linprog(c[k], A_eq=A[k], b_eq=b[k], bounds=(0, None),
                      method="highs")
        if res.status == 2:
            assert status[k] == lp.INFEASIBLE
            continue
        assert res.status == 0 and status[k] == lp.OPTIMAL
        assert fun[k] == pytest.approx(res.fun, abs=1e-7)
        slack_free = np.concatenate([x[k], np.zeros(A.shape[2] - NV)])
        assert (A[k, :2] @ slack_free <= b[k, :2] + 1e-9).all()


@pytest.mark.parametrize("method", ["tableau", "revised"])
@pytest.mark.parametrize("seed,degenerate", [(0, False), (1, False),
                                             (9, True)])
def test_cold_solve_matches_reference_and_scipy(method, seed, degenerate):
    data = _fleet(seed, degenerate)
    got = _port_solve(*data, None, None, method)
    _assert_same_optimum(got, _ref_solve(*data, None, None, method))
    assert (got[2] == lp.INFEASIBLE).any() == degenerate  # ES-disabled
    _assert_scipy_optimum(data, got)


@pytest.mark.parametrize("method", ["tableau", "revised"])
def test_warm_restart_from_reference_optimum_is_exact(method):
    """Warm from the reference's own optimal bases on the same data: the
    same lanes are accepted, each in 0 pivots, keeping its basis
    exactly."""
    data = _fleet(2)
    cold = _ref_solve(*data, None, None, method)
    basis0 = cold[4].copy()
    basis0[::5] = -1                        # rejected: cold in the same call
    got = _port_solve(*data, basis0, None, method)
    want = _ref_solve(*data, basis0, None, method)
    _assert_same_optimum(got, want)
    ok = want[5]
    assert ok.sum() > B // 2 and not ok[::5].any()
    np.testing.assert_array_equal(got[3][ok], 0)
    np.testing.assert_array_equal(got[3][ok], want[3][ok])
    np.testing.assert_array_equal(got[4][ok], basis0[ok])
    np.testing.assert_array_equal(got[4][ok], want[4][ok])


@pytest.mark.parametrize("method", ["tableau", "revised"])
def test_warm_solve_after_drift_matches_reference(method):
    p_ed, p_es, acc, T = _fleet(3)
    first = _port_solve(p_ed, p_es, acc, T, None, None, method)
    rng = np.random.default_rng(4)
    T2 = T * rng.uniform(0.7, 1.1, B)      # tighter budgets: some repairs
    p_ed2 = p_ed * rng.uniform(0.9, 1.3, p_ed.shape)
    got = _port_solve(p_ed2, p_es, acc, T2, first[4], None, method)
    want = _ref_solve(p_ed2, p_es, acc, T2, first[4], None, method)
    _assert_same_optimum(got, want)
    ok = got[5]
    assert ok.sum() > B // 2
    assert got[3][ok].sum() < first[3][ok].sum()       # warm saves pivots


@pytest.mark.parametrize("method", ["tableau", "revised"])
def test_lane_mask_matches_reference(method):
    data = _fleet(5)
    mask = np.random.default_rng(5).uniform(size=B) < 0.5
    got = _port_solve(*data, None, mask, method)
    want = _ref_solve(*data, None, mask, method)
    _assert_same_optimum(got, want)
    np.testing.assert_array_equal(got[3][~mask], 0)    # masked: 0 pivots
    np.testing.assert_array_equal(want[3][~mask], 0)


def test_methods_agree_on_status_and_optimum():
    data = _fleet(6)
    t = _port_solve(*data, None, None, "tableau")
    r = _port_solve(*data, None, None, "revised")
    _assert_same_optimum(r, t)


def test_iteration_cap_and_float64_contract():
    data = _fleet(7)
    A, b, c = _port_arrays(*data)
    out = lp.simplex_batch_core(A, b, c, None, nv=NV, maxiter=3)
    assert (to_numpy(out[2]) == lp.ITERATION_LIMIT).any()
    assert (to_numpy(out[3]) <= 3).all()
    with pytest.raises(TypeError, match="float64"):
        lp.simplex_batch_core(A.float(), b.float(), c.float(), None,
                              nv=NV, maxiter=MAXITER)
    with pytest.raises(ValueError, match="unknown simplex method"):
        lp.simplex_batch_core(A, b, c, None, nv=NV, maxiter=MAXITER,
                              method="dense")


def test_batched_inverse_matches_reference():
    rng = np.random.default_rng(8)
    Bmat = rng.normal(size=(16, 7, 7))
    Bmat[3] = 0.0                                     # singular lane
    got = to_numpy(lp._batched_inverse(torch.as_tensor(Bmat)))
    with reference_x64():
        want = np.asarray(jax.jit(jlp._batched_inverse)(jnp.asarray(Bmat)))
    ok = np.isfinite(want).all(axis=(1, 2))
    assert not ok[3]
    np.testing.assert_array_equal(got[ok], want[ok])
    np.testing.assert_allclose(got[ok] @ Bmat[ok],
                               np.broadcast_to(np.eye(7), got[ok].shape),
                               atol=1e-9)


def test_bucket_maxiter_matches_reference():
    for v in (1, 50, 800, 801, 1024):
        assert lp._bucket_maxiter(v) == jlp._bucket_maxiter(v)


def _standard_form(seed, degenerate=False):
    """The fleet LPs of `_fleet` in the standard form the host entry
    points take."""
    from repro.core.amr2 import build_lp_arrays_batch
    from repro.core.types import InstanceBatch
    return build_lp_arrays_batch(InstanceBatch(*_fleet(seed, degenerate)))


@pytest.mark.parametrize("method", ["tableau", "revised"])
def test_solve_lp_batch_matches_reference(method):
    """Cold, then warm from the cold bases with some rows -1: statuses,
    warm flags and pivots of accepted lanes exact, optima to 1e-9."""
    arrays = _standard_form(11, degenerate=True)
    with reference_x64():
        cold_want = jlp.solve_lp_batch(*arrays, method=method)
    cold = lp.solve_lp_batch(*arrays, method=method, device="cpu")
    warm_basis = cold.basis.copy()
    warm_basis[::4] = -1
    with reference_x64():
        warm_want = jlp.solve_lp_batch(*arrays, method=method,
                                       warm_basis=warm_basis)
    warm = lp.solve_lp_batch(*arrays, method=method, warm_basis=warm_basis,
                             device="cpu")
    for got, want in ((cold, cold_want), (warm, warm_want)):
        np.testing.assert_array_equal(got.status, want.status)
        np.testing.assert_array_equal(got.warm, want.warm)
        opt = want.status == lp.OPTIMAL
        np.testing.assert_allclose(got.x[opt], want.x[opt], atol=1e-9,
                                   rtol=0)
        np.testing.assert_allclose(got.fun[opt], want.fun[opt], atol=1e-9,
                                   rtol=0)
    ok = warm.warm
    assert ok.sum() > B // 2 and not ok[::4].any()
    np.testing.assert_array_equal(warm.niter[ok], warm_want.niter[ok])
    np.testing.assert_array_equal(warm.basis[ok], cold.basis[ok])
    with pytest.raises(ValueError, match="warm_basis"):
        lp.solve_lp_batch(*arrays, warm_basis=warm_basis[:, :3],
                          device="cpu")


def test_solve_lp_single_matches_reference():
    c, A_ub, b_ub, A_eq, b_eq = (x[4] for x in _standard_form(12))
    with reference_x64():
        want = jlp.solve_lp(c, A_ub, b_ub, A_eq, b_eq, backend="jax")
        warm_want = jlp.solve_lp(c, A_ub, b_ub, A_eq, b_eq, backend="jax",
                                 warm_basis=want.basis)
    got = lp.solve_lp(c, A_ub, b_ub, A_eq, b_eq, device="cpu")
    warm = lp.solve_lp(c, A_ub, b_ub, A_eq, b_eq, warm_basis=got.basis,
                       device="cpu")
    assert got.status == want.status == lp.OPTIMAL and got.success
    assert got.fun == pytest.approx(want.fun, abs=1e-9)
    np.testing.assert_allclose(got.x, want.x, atol=1e-9, rtol=0)
    assert warm.warm and warm_want.warm and warm.niter == 0
    np.testing.assert_array_equal(warm.basis, got.basis)
