"""The port's online hierarchical inference (`repro_torch.core.hi`)
against the reference's `repro.core.hi`.

* `HIModel.make` / `from_profiles` / `is_null` and `validate_hi`: the same
  values and the same errors.
* `arm_grid` bit for bit for K in 2..16 (a one-ulp difference in a
  threshold can flip ``conf < theta``).
* `sample_confidence` on the reference's `presample_stream` uniforms:
  confidences to 1e-12, outcomes exact.
* `hi_period` for the four rules, five periods chained, on the same
  inputs: decisions and arms exact, learner state to 1e-12.  EXP3 is fed
  the reference's arm uniforms (drawn from the second half of its period
  key, folded by device id).
* Inside the port: `presample_stream` replays the drawn stream bit for
  bit; the calibration holds by distribution (mean confidence within 4
  standard errors of the local accuracy, hit rate within a confidence
  bin); UCB takes the first of tied arms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hi as RH
from repro_torch.core import hi as PH
from test_torch_parity_util import (reference_arm_uniforms, reference_x64,
                                    to_numpy)

D, N, PERIODS, SEED = 6, 8, 5, 3
CPU = torch.device("cpu")


def _t(x):
    return torch.as_tensor(np.array(x))


def _inputs():
    rng = np.random.default_rng(0)
    acc_local = rng.uniform(0.5, 0.9, D)
    acc_es = rng.uniform(0.85, 0.97, D)
    ci = rng.integers(0, 3, (D, N)).astype(np.int32)
    mask = np.arange(N)[None] < rng.integers(0, N + 1, D)[:, None]
    mask[0] = True                     # a full device and ...
    mask[1] = False                    # ... an idle one
    return acc_local, acc_es, ci, mask


def test_model_make_profiles_and_errors_match_reference():
    kw = dict(spread=[0.2, 0.9], offload_cost=0.1, lr=0.3, tau=0.07,
              theta0=[0.4, 0.6, 0.5], explore=0.8)
    ref, port = RH.HIModel.make(**kw), PH.HIModel.make(**kw)
    for f in PH.HI_MODEL_FIELDS:
        np.testing.assert_array_equal(to_numpy(getattr(port, f)),
                                      np.asarray(getattr(ref, f)), f)
    assert PH.HIModel.none().is_null() and not port.is_null()
    assert RH.HIModel.none().is_null()
    p_ed = np.array([[0.3, 0.2], [0.1, 0.05], [0.6, 0.5], [0.2, 0.2]])
    for tbl in (p_ed, np.broadcast_to(p_ed, (5, 4, 2))):
        np.testing.assert_array_equal(
            to_numpy(PH.HIModel.from_profiles(
                _t(tbl), spread_range=(0.2, 0.8)).spread),
            RH.HIModel.from_profiles(tbl, spread_range=(0.2, 0.8)).spread)
    bad = [dict(spread=1.5), dict(offload_cost=1.0), dict(lr=0.0),
           dict(theta0=-0.1), dict(explore=-1.0),
           dict(conf_trace=np.zeros((2, 4, 8)))]
    for b in bad:
        with pytest.raises(ValueError) as want:
            RH.HIModel.make(**b)
        with pytest.raises(ValueError) as got:
            PH.HIModel.make(**b)
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    with pytest.raises(ValueError, match="spread_range"):
        PH.HIModel.from_profiles(p_ed, spread_range=(0.9, 0.2))


@pytest.mark.parametrize("case", [
    dict(rule="softmax"), dict(stream="mmap"), dict(rule="ucb", n_arms=1),
    dict(local_model=2), dict(spread=[0.5, 0.5]), dict(theta0=[0.5, 0.5]),
    dict(stream="replay"),
    dict(stream="replay", conf_trace=np.zeros((2, 4, 6, 3)), batch_max=8),
    dict()])
def test_validate_hi_matches_reference(case):
    expect_ok = not case
    case = dict(case)
    model_kw = {k: case.pop(k) for k in ("spread", "theta0", "conf_trace")
                if k in case}
    kw = dict(n_devices=4, n_classes=3, n_models=2, rule="fixed",
              stream="fold", n_arms=9, local_model=0)
    kw.update(case)
    outcomes = []
    for mod in (RH, PH):
        try:
            mod.validate_hi(mod.HIModel.make(**model_kw), **kw)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == expect_ok


def test_arm_grid_bit_for_bit():
    for K in range(2, 17):
        with reference_x64():
            want = np.asarray(RH.arm_grid(K))
        got = to_numpy(PH.arm_grid(K))
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want, err_msg=f"K={K}")


def test_sample_confidence_and_hi_period_match_reference():
    acc_local, acc_es, ci, mask = _inputs()
    with reference_x64():
        trace = RH.presample_stream(SEED, D, N, PERIODS)
    rhm = RH.HIModel.make(spread=[0.3, 0.6, 0.9], conf_trace=trace)
    phm = PH.HIModel.make(spread=[0.3, 0.6, 0.9], conf_trace=trace)
    K = 5
    for rule in PH.HI_RULES:
        with reference_x64():
            rst = RH.HILearnerState.init(D, K, 0.5)
        pst = PH.HILearnerState.init(D, K, 0.5, device=CPU)
        for t in range(PERIODS):
            with reference_x64():
                rc = RH.sample_confidence(None, rhm, acc_local, acc_es, ci,
                                          uniforms=jnp.asarray(trace[t]))
                ka = jax.random.split(jax.random.fold_in(
                    jax.random.PRNGKey(SEED), t))[1]
                out = jax.tree.map(np.asarray, RH.hi_period(
                    rule, rhm, rst, *rc, mask, acc_es, t, ka, K))
            pc = PH.sample_confidence(None, phm, _t(acc_local), _t(acc_es),
                                      _t(ci), uniforms=phm.conf_trace[t])
            np.testing.assert_allclose(to_numpy(pc[0]), np.asarray(rc[0]),
                                       rtol=0, atol=1e-12)
            for a, b in zip(pc[1:], rc[1:]):
                np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
            arm_u = reference_arm_uniforms(SEED, t, D)
            got = PH.hi_period(rule, phm, pst, *pc, _t(mask), _t(acc_es), t,
                               None, K, arm_u=_t(arm_u))
            np.testing.assert_array_equal(to_numpy(got[0]), out[0])
            np.testing.assert_allclose(to_numpy(got[1]), out[1], rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(to_numpy(got[3]), out[3], rtol=0,
                                       atol=1e-12)
            for f in PH.HI_STATE_FIELDS:
                a, b = to_numpy(getattr(got[2], f)), getattr(out[2], f)
                if f == "arm":
                    np.testing.assert_array_equal(a, b, err_msg=f)
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12,
                                               err_msg=f"{rule} t={t} {f}")
            rst, pst = out[2], got[2]
        assert float(pst.cum_regret.sum()) >= 0.0
        if rule in ("ucb", "exp3"):
            np.testing.assert_array_equal(
                to_numpy(pst.arms_cnt.sum(dim=1)),
                np.where(mask.any(axis=1), PERIODS, 0))


def test_presample_replays_the_drawn_stream():
    """`presample_stream` holds each period's draw bit for bit, and EXP3
    draws its arms from a stream of its own."""
    tr = PH.presample_stream(7, 3, 5, 4, device=CPU)
    assert tr.shape == (4, 3, 5, 3) and tr.dtype == torch.float64
    for t in range(4):
        assert torch.equal(tr[t], PH.draw_uniforms(7, t, 3, 5, CPU))
    assert not torch.equal(tr[0], tr[1])
    assert not torch.equal(PH.draw_arm_uniforms(7, 0, 3, CPU), tr[0, :, 0, 0])


def test_confidence_is_calibrated_by_distribution():
    """E[conf] == acc_local within 4 standard errors, P(correct | conf)
    == conf within a confidence bin, ES outcomes Bernoulli(acc_es), and a
    wider spread swings wider."""
    n = 20_000
    acc_local = _t(np.array([0.55, 0.7, 0.8, 0.92]))
    acc_es = _t(np.array([0.9, 0.85, 0.95, 0.97]))
    ci = torch.zeros((4, n), dtype=torch.int32)
    conf, cl, ces = PH.sample_confidence((3, 0), PH.HIModel.make(spread=0.8),
                                         acc_local, acc_es, ci)
    se = conf.std(dim=1) / np.sqrt(n)
    assert bool(((conf.mean(dim=1) - acc_local).abs() <= 4 * se).all())
    for x, p in ((cl, acc_local), (ces, acc_es)):
        freq = x.to(torch.float64).mean(dim=1)
        assert bool(((freq - p).abs() <= 4 * (p * (1 - p) / n).sqrt()).all())
    for d in range(4):
        for lo in (0.3, 0.5, 0.7):
            sel = (conf[d] >= lo) & (conf[d] < lo + 0.2)
            if int(sel.sum()) > 500:
                gap = cl[d, sel].to(torch.float64).mean() - conf[d, sel].mean()
                assert abs(float(gap)) < 0.05
    narrow, _, _ = PH.sample_confidence((3, 0), PH.HIModel.make(spread=0.1),
                                        acc_local, acc_es, ci)
    assert float(narrow.std()) < float(conf.std())


def test_ucb_takes_the_first_of_tied_arms():
    """Untried arms carry an infinite bonus and equal means tie: the arm
    is the first maximum (as `jnp.argmax`), so the grid sweeps in index
    order."""
    hm = PH.HIModel.make()
    st = PH.HILearnerState.init(2, 4, 0.5, device=CPU)
    st = PH.HILearnerState(**{**{f: getattr(st, f)
                                 for f in PH.HI_STATE_FIELDS},
                              "arms_cnt": _t(np.array([[1., 0, 0, 0],
                                                       [1., 1, 0, 1]])),
                              "arms_sum": _t(np.array([[.5, 0, 0, 0],
                                                       [.5, .5, 0, .5]]))})
    conf = torch.full((2, 3), 0.5, dtype=torch.float64)
    no = torch.zeros((2, 3), dtype=torch.bool)
    mask = torch.ones((2, 3), dtype=torch.bool)
    _off, theta, new, _r = PH.hi_period("ucb", hm, st, conf, no, no, mask,
                                        _t(np.array([0.9, 0.9])), 3, None, 4)
    assert new.arm.tolist() == [1, 2]
    np.testing.assert_array_equal(to_numpy(theta),
                                  to_numpy(PH.arm_grid(4))[[1, 2]])
