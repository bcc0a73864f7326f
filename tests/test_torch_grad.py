"""The differentiable rollout of the port against the reference.

* LP layer: `kkt_vjp_ref` against the reference's on the same converged
  bases (1e-10); `simplex_batch_grad`'s forward bit for bit
  `simplex_batch_core` for both methods; its VJP against the reference's
  ``jax.vjp`` (1e-9) and central finite differences (rtol 1e-4) on the
  reference test's `_lp_batch` seeds 0-2; masked and non-OPTIMAL lanes
  give exact zeros.
* The relaxed stages: `soft_assignment_weights` and
  `straight_through_weights` values and Jacobians against the
  reference's (1e-12); `admit_mask_pool` passes gradients from the
  demands to ``inc``.
* The engine: `rollout_value_and_grad` against the reference's on its
  `_diff_params` recipe (jittered ``p_es``, seeds 0-2) for ``p_es``,
  ``T``, ``acc`` and ``base_p_ed`` (rtol 1e-8); central finite
  differences (rtol 1e-4); with slower ED latencies, where the ED budget
  row binds, a non-zero ``base_p_ed`` gradient against the reference's
  (rtol 1e-8) and central differences; the straight-through value equal
  to the hard rollout (1e-9); the validators; `partition_diff` /
  `combine_diff`.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import engine as RE
from repro.core import lp as RL
from repro.kernels.simplex_pivot import ref as RREF
from repro.serving import FleetConfig as RefConfig
from repro_torch import convert
from repro_torch.api import engine as PE
from repro_torch.core import amr2 as PA
from repro_torch.core import lp as PL
from repro_torch.core.faults import FaultModel
from repro_torch.core.hi import HIModel
from repro_torch.core.mobility import admit_mask_pool
from repro_torch.kernels.simplex_pivot import ref as PREF
from test_torch_parity_util import reference_x64, to_numpy

# `repro.core.amr2` is shadowed by the function of that name in `repro.core`
RA = importlib.import_module("repro.core.amr2")
RTOL, ATOL = 1e-4, 1e-6        # finite differences (the reference's bar)
CPU = "cpu"
WRT = ("p_es", "T", "acc", "base_p_ed")


def _lp_batch(seed, nb=4, n=6, mc=3):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(nb, n))
    A_ub = rng.uniform(0, 1, size=(nb, mc, n))
    b_ub = rng.uniform(1, 3, size=(nb, mc))
    return c, A_ub, b_ub, np.ones((nb, 1, n)), np.ones((nb, 1))


def _canon(seed):
    A, b, cf, nv, _ = PL._canonicalize_batch(*_lp_batch(seed))
    return A, b, cf, nv


def _assert_close(fd, an, label):
    if abs(fd - an) < ATOL:
        return
    rel = abs(fd - an) / max(abs(fd), abs(an))
    assert rel < RTOL, f"{label}: fd={fd!r} analytic={an!r} rel={rel:.3e}"


def test_kkt_vjp_matches_reference():
    A, b, cf, nv = _canon(0)
    out = PL.simplex_batch_core(*(torch.as_tensor(x) for x in (A, b, cf)),
                                None, nv=nv, maxiter=200)
    bases, status = out[4], out[2]
    rng = np.random.default_rng(9)
    gx, gfun = rng.normal(size=(4, nv)), rng.normal(size=4)
    valid = np.array([True, True, False, True]) & (to_numpy(status) == 0)
    got = PREF.kkt_vjp_ref(*(torch.as_tensor(x) for x in (A, b, cf)), bases,
                           torch.as_tensor(gx), torch.as_tensor(gfun),
                           torch.as_tensor(valid), nv=nv)
    with reference_x64():
        want = RREF.kkt_vjp_ref(jnp.asarray(A), jnp.asarray(b),
                                jnp.asarray(cf), jnp.asarray(to_numpy(bases)),
                                jnp.asarray(gx), jnp.asarray(gfun),
                                jnp.asarray(valid), nv=nv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0,
                                   atol=1e-10)
    assert float(got[1][2].abs().sum()) == 0.0        # the invalid lane
    Bm, real = PREF.basis_columns_ref(torch.as_tensor(A), bases)
    with reference_x64():
        Bw, rw = RREF.basis_columns_ref(jnp.asarray(A),
                                        jnp.asarray(to_numpy(bases)))
    np.testing.assert_array_equal(to_numpy(Bm), np.asarray(Bw))
    np.testing.assert_array_equal(to_numpy(real), np.asarray(rw))


@pytest.mark.parametrize("method", ["tableau", "revised"])
def test_grad_forward_is_bitwise_the_core(method):
    for seed in (0, 3):
        A, b, cf, nv = (torch.as_tensor(x) if isinstance(x, np.ndarray)
                        else x for x in _canon(seed))
        kw = dict(nv=nv, maxiter=200, method=method)
        want = PL.simplex_batch_core(A, b, cf, None, **kw)
        got = PL.simplex_batch_grad(A.clone().requires_grad_(), b, cf, None,
                                    **kw)
        for w, g in zip(want, got):
            assert torch.equal(w, g.detach())
        warm = PL.simplex_batch_grad(A, b, cf, want[4], **kw)
        for w, g in zip(PL.simplex_batch_core(A, b, cf, want[4], **kw),
                        warm):
            assert torch.equal(w, g)


def _loss_terms(seed, nv):
    rng = np.random.default_rng(seed + 77)
    return rng.normal(size=(4, nv)), rng.normal(size=4)


def _port_loss(A, b, cf, nv, wx, wf, method="tableau"):
    x, fun, status, *_ = PL.simplex_batch_grad(A, b, cf, None, nv=nv,
                                               maxiter=200, method=method)
    ok = status == PL.OPTIMAL
    return (torch.where(ok[:, None], torch.as_tensor(wx) * x[:, :nv], 0.0)
            .sum() + torch.where(ok, torch.as_tensor(wf) * fun, 0.0).sum())


_REF_GRAD = {}


def _ref_lp_grad(method):
    """The reference's gradient of the same loss through its
    `simplex_batch_grad`, jitted once per method (the batches share a
    shape)."""
    if method not in _REF_GRAD:
        def loss(A_, b_, c_, wx, wf):
            x, fun, status, *_ = RL.simplex_batch_grad(
                A_, b_, c_, None, nv=wx.shape[1], maxiter=200,
                method=method)
            ok = (status == RL.OPTIMAL)[:, None]
            return (jnp.sum(jnp.where(ok, wx * x[:, :wx.shape[1]], 0.0))
                    + jnp.sum(jnp.where(ok[:, 0], wf * fun, 0.0)))
        _REF_GRAD[method] = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    return _REF_GRAD[method]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lp_vjp_matches_reference_and_finite_differences(seed):
    A, b, cf, nv = _canon(seed)
    wx, wf = _loss_terms(seed, nv)
    leaves = [torch.tensor(x, requires_grad=True) for x in (A, b, cf)]
    for method in ("tableau", "revised"):
        g_port = torch.autograd.grad(
            _port_loss(*leaves, nv, wx, wf, method), leaves)
        with reference_x64():
            g_ref = _ref_lp_grad(method)(*(jnp.asarray(x) for x in (
                A, b, cf, wx, wf)))
        for g, w in zip(g_port, g_ref):
            np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0,
                                       atol=1e-9)
    # central differences on b and c (eps 1e-6), three coordinates each
    rng = np.random.default_rng(seed + 78)
    g_b, g_c = (to_numpy(g) for g in torch.autograd.grad(
        _port_loss(torch.as_tensor(A), leaves[1], leaves[2], nv, wx, wf),
        leaves[1:]))
    for arr, g, name in ((b, g_b, "b"), (cf, g_c, "c")):
        for idx in rng.choice(arr.size, size=3, replace=False):
            vals = []
            for eps in (1e-6, -1e-6):
                pert = arr.copy().ravel()
                pert[idx] += eps
                args = [A, b, cf]
                args[1 if name == "b" else 2] = pert.reshape(arr.shape)
                vals.append(float(_port_loss(*(torch.as_tensor(x)
                                                 for x in args), nv, wx, wf)))
            _assert_close((vals[0] - vals[1]) / 2e-6, g.ravel()[idx],
                          f"seed={seed} {name}[{idx}]")


def test_masked_and_unsolved_lanes_give_exact_zeros():
    A, b, cf, nv = _canon(3)
    mask = torch.tensor([True, False, True, False])
    bb = torch.tensor(b, requires_grad=True)
    _x, fun, status, *_ = PL.simplex_batch_grad(
        torch.as_tensor(A), bb, torch.as_tensor(cf), None, nv=nv,
        maxiter=200, lane_mask=mask)
    (g,) = torch.autograd.grad(torch.where(mask, fun, 0.0).sum(), bb)
    assert bool(torch.isfinite(g).all())
    assert float(g[~mask].abs().sum()) == 0.0 and float(g.abs().sum()) > 0
    # an iteration limit: no lane reaches OPTIMAL, every cotangent is 0
    bb = torch.tensor(b, requires_grad=True)
    _x, fun, status, *_ = PL.simplex_batch_grad(
        torch.as_tensor(A), bb, torch.as_tensor(cf), None, nv=nv, maxiter=1)
    assert bool((status != PL.OPTIMAL).all())
    (g,) = torch.autograd.grad(fun.sum(), bb)
    assert float(g.abs().sum()) == 0.0


@pytest.mark.parametrize("tau", [0.25, 1.0])
def test_relaxed_rounding_weights_match_reference(tau):
    rng = np.random.default_rng(4)
    xbar = rng.dirichlet(np.ones(3), size=(5, 4))
    xbar[0, 0] = [1.0, 0.0, 0.0]                    # an integral row
    xbar[1, 2] = [0.0, 0.3, 0.7]
    assign = xbar.argmax(axis=2).astype(np.int32)
    cot = rng.normal(size=xbar.shape)
    for name in ("soft", "st"):
        x = torch.tensor(xbar, requires_grad=True)
        if name == "soft":
            w = PA.soft_assignment_weights(x, tau=tau)
        else:
            w = PA.straight_through_weights(x, torch.as_tensor(assign),
                                            tau=tau)
        (g,) = torch.autograd.grad((w * torch.as_tensor(cot)).sum(), x)
        with reference_x64():
            fn = ((lambda z: RA.soft_assignment_weights(z, tau=tau))
                  if name == "soft" else
                  (lambda z: RA.straight_through_weights(
                      z, jnp.asarray(assign), tau=tau)))
            ww, vjp = jax.vjp(fn, jnp.asarray(xbar))
            (gw,) = vjp(jnp.asarray(cot))
        np.testing.assert_allclose(to_numpy(w), np.asarray(ww), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(to_numpy(g), np.asarray(gw), rtol=0,
                                   atol=1e-12)


def test_admission_passes_gradients_to_inc():
    d = torch.tensor([0.3, 0.0, 0.5, 0.2, 0.45], dtype=torch.float64,
                     requires_grad=True)
    admitted, _loads, inc = admit_mask_pool(d, torch.tensor(
        1.0, dtype=torch.float64), 2)
    (g,) = torch.autograd.grad(inc.sum(), d)
    # sorted 0.2, 0.3, 0.45, 0.5 and the idle device last, round-robin
    # on two servers: inc is each device's running server load, so an
    # earlier demand counts again in every later slot of its server (the
    # idle device's slot too, as in the reference)
    assert g.tolist() == [2.0, 0.0, 1.0, 3.0, 2.0]
    assert admitted.tolist() == [True, False, True, True, True]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _cfg(seed):
    return dict(n_devices=8, T=1.2, n_servers=2, policy="amr2", rate=9.0,
                batch_max=8, horizon=6, seed=seed, straggler_frac=0.25,
                outage_frac=0.1)


def _diff_pair(seed, smooth_mode="soft", jitter=True, ed_scale=1.0):
    """The reference's `_diff_params` (tests/test_grad.py), its ED
    latencies times ``ed_scale``, and the port's params carried across
    from it."""
    ref = RE.EngineParams.from_config(
        RefConfig(backend="jax", **_cfg(seed)), horizon=6
    ).with_differentiable(smooth_mode=smooth_mode)
    if jitter:
        rng = np.random.default_rng(1000 + seed)
        arr = np.asarray(ref.p_es, np.float64)
        nudge = (rng.uniform(1e-3, 3e-3, size=arr.shape)
                 * rng.choice([-1.0, 1.0], size=arr.shape))
        ref = dataclasses.replace(ref, p_es=arr + nudge)
    if ed_scale != 1.0:
        ref = dataclasses.replace(
            ref, base_p_ed=np.asarray(ref.base_p_ed, np.float64) * ed_scale)
    fields = {f: getattr(ref, f) for f in RE._PARAM_LEAVES + RE._PARAM_AUX
              if f not in ("faults", "mobility", "hi")}
    return ref, convert.params_from_numpy(fields, CPU)


def _value(params, periods=4):
    _s, m = PE.rollout(PE.init_state(params, device=CPU), params, periods,
                       device=CPU)
    return float(m.total_accuracy.sum())


def _fd_leaf(params, leaf, idx, eps=1e-5):
    base = getattr(params, leaf)
    vals = []
    for e in (eps, -eps):
        pert = base.clone().reshape(-1)
        pert[idx] += e
        vals.append(_value(dataclasses.replace(
            params, **{leaf: pert.reshape(base.shape)})))
    return (vals[0] - vals[1]) / (2 * eps)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rollout_grad_matches_reference(seed):
    ref, port = _diff_pair(seed)
    with reference_x64():
        rv, rg = RE.rollout_value_and_grad(RE.init_state(ref), ref, 4,
                                           wrt=WRT)
    pv, pg = PE.rollout_value_and_grad(PE.init_state(port, device=CPU), port,
                                       4, wrt=WRT, device=CPU)
    np.testing.assert_allclose(float(pv), float(rv), rtol=1e-12)
    assert set(pg) == set(WRT)
    for f in WRT:
        g, w = to_numpy(pg[f]), np.asarray(rg[f])
        assert g.shape == w.shape, f
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max(), err_msg=f)
    for f in ("p_es", "acc", "T"):
        assert float(pg[f].abs().sum()) > 0, f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rollout_grad_matches_finite_differences(seed):
    _ref, params = _diff_pair(seed)
    _v, grads = PE.rollout_value_and_grad(PE.init_state(params, device=CPU),
                                          params, 4, device=CPU)
    assert set(grads) == set(params.grad_leaves)
    rng = np.random.default_rng(seed + 55)
    g_es = to_numpy(grads["p_es"]).ravel()
    for idx in rng.choice(g_es.size, size=2, replace=False):
        _assert_close(_fd_leaf(params, "p_es", idx), g_es[idx],
                      f"seed={seed} p_es[{idx}]")
    _assert_close(_fd_leaf(params, "T", 0), float(grads["T"]),
                  f"seed={seed} T")
    g_acc = to_numpy(grads["acc"]).ravel()
    idx = int(rng.integers(g_acc.size))
    _assert_close(_fd_leaf(params, "acc", idx), g_acc[idx],
                  f"seed={seed} acc[{idx}]")


# On `_diff_params` the ED budget row never binds, so the gradient with
# respect to ``base_p_ed`` is exactly 0 in both packages.  Five times
# slower ED latencies make the row bind: the gradient then reaches
# ``base_p_ed`` only through the LP's ED coefficients and the beliefs
# re-rooted at ``base_p_ed`` (`rollout_value_and_grad`).
SLOW_ED = 5.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rollout_grad_base_p_ed_where_the_ed_row_binds(seed):
    ref, params = _diff_pair(seed, ed_scale=SLOW_ED)
    with reference_x64():
        rv, rg = RE.rollout_value_and_grad(RE.init_state(ref), ref, 4,
                                           wrt=WRT)
    pv, pg = PE.rollout_value_and_grad(PE.init_state(params, device=CPU),
                                       params, 4, wrt=WRT, device=CPU)
    np.testing.assert_allclose(float(pv), float(rv), rtol=1e-10)
    for f in WRT:
        g, w = to_numpy(pg[f]), np.asarray(rg[f])
        np.testing.assert_allclose(g, w, rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max(), err_msg=f)
    g_ed = to_numpy(pg["base_p_ed"]).ravel()
    assert np.abs(g_ed).max() > 0.1
    for idx in np.argsort(-np.abs(g_ed), kind="stable")[:2]:
        _assert_close(_fd_leaf(params, "base_p_ed", idx), g_ed[idx],
                      f"seed={seed} base_p_ed[{idx}]")


@pytest.mark.parametrize("lp_method", ["tableau", "revised"])
def test_straight_through_value_is_the_hard_rollout(lp_method):
    _ref, params = _diff_pair(0, smooth_mode="st", jitter=False)
    params = dataclasses.replace(params, lp_method=lp_method)
    hard = dataclasses.replace(params, differentiable=False)
    val, grads = PE.rollout_value_and_grad(PE.init_state(params, device=CPU),
                                           params, 4, device=CPU)
    assert abs(float(val) - _value(hard)) <= 1e-9
    for f, g in grads.items():
        assert g.shape == getattr(params, f).shape, f
        assert bool(torch.isfinite(g).all()), f
    # the relaxed forward plans and admits exactly as the hard one
    s_d, m_d = PE.rollout(PE.init_state(params, device=CPU), params, 4,
                          device=CPU)
    s_h, m_h = PE.rollout(PE.init_state(hard, device=CPU), hard, 4,
                          device=CPU)
    for f in PE.METRIC_FIELDS:
        if f not in ("total_accuracy", "mean_job_accuracy"):
            assert torch.equal(getattr(m_d, f), getattr(m_h, f)), f
    assert torch.equal(s_d.warm_basis, s_h.warm_basis)


def test_validators_and_entry_guards():
    _ref, params = _diff_pair(0, jitter=False)
    plain = params.with_differentiable(False)
    assert not plain.differentiable
    with pytest.raises(ValueError, match="smooth_mode"):
        plain.with_differentiable(smooth_mode="gumbel")
    with pytest.raises(ValueError, match="must be > 0"):
        plain.with_differentiable(smooth_tau=0.0)
    with pytest.raises(ValueError, match="not differentiable"):
        plain.with_differentiable(grad_leaves=("warm_basis",))
    with pytest.raises(ValueError, match="chaos"):
        plain.with_faults(FaultModel.make(es_crash_prob=0.1),
                          fault_seed=1).with_differentiable()
    with pytest.raises(ValueError, match="HI disarmed"):
        plain.with_hi(HIModel.make()).with_differentiable()
    with pytest.raises(ValueError, match="policy='amr2'"):
        dataclasses.replace(plain, policy="dual").with_differentiable()
    state = PE.init_state(plain, device=CPU)
    with pytest.raises(ValueError, match="with_differentiable"):
        PE.rollout_grad(state, plain, 2, device=CPU)
    with pytest.raises(ValueError, match="not differentiable"):
        PE.rollout_grad(state, params, 2, wrt=("stream",), device=CPU)
    g = PE.rollout_grad(state, params.with_differentiable(
        grad_leaves=("T",)), 2, device=CPU)
    assert set(g) == {"T"} and g["T"].shape == ()


def test_partition_and_combine_round_trip():
    _ref, params = _diff_pair(0, jitter=False)
    state = PE.init_state(params.with_differentiable(False).with_hi(
        HIModel.make()), device=CPU)
    for value in (state, params):
        diff, nondiff = PE.partition_diff(value)
        back = PE.combine_diff(diff, nondiff)
        for name, leaf in PE._leaves(value).items():
            assert torch.equal(PE._leaves(back)[name], leaf), name
        for name, leaf in PE._leaves(diff).items():
            assert leaf.is_floating_point(), name
        for name, leaf in PE._leaves(nondiff).items():
            assert not leaf.is_floating_point(), name
    diff, nondiff = PE.partition_diff(state)
    assert diff.pending is PE._NONDIFF and nondiff.p_ed is PE._NONDIFF
    assert diff.hi.arm is PE._NONDIFF and diff.hi.theta is state.hi.theta
    p_ed = diff.p_ed.clone().requires_grad_()
    whole = PE.combine_diff(dataclasses.replace(diff, p_ed=p_ed), nondiff)
    (g,) = torch.autograd.grad(whole.p_ed.sum(), p_ed)
    assert torch.equal(g, torch.ones_like(state.p_ed))
    assert diff.p_ed.dtype == torch.float64
