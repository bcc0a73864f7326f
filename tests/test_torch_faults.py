"""The port's fault model and degradation ladder (`repro_torch.core.faults`)
against the reference's `repro.core.faults`.

* `FaultModel` validation, messages and nullness as the reference's, and
  `convert.fault_model_from_numpy` carrying the reference's model across;
* `realize_execution` against the reference on the same NumPy inputs and
  the same realization (an ES crash, per-attempt losses, degraded links and
  stragglers; 0-3 retry rounds): integer counters exact, floats to 1e-12;
* the ladder identity ``n_offload == n_offload_ok + n_fallback_local +
  n_dropped`` per device and the realized ES time within ``2T +
  backoff_cap + demand x link``;
* the null realization reproducing the priced execution bit for bit;
* `sample_realization` by distribution only (torch cannot redraw jax's
  threefry streams): crash, link, straggler and loss frequencies within 5
  standard errors at 4096 devices; the same key gives the same draw,
  another key another.
"""
import numpy as np
import pytest
import torch

from repro.core import faults as RF
from repro_torch import convert
from repro_torch.core.faults import (FaultModel, FaultRealization,
                                     realize_execution, sample_realization)
from repro_torch.serving import faults as serving_faults
from test_torch_parity_util import reference_x64, to_numpy

HARSH = dict(es_crash_prob=0.08, link_degrade_prob=0.25,
             link_degrade_mag=0.6, straggler_prob=0.2, straggler_mult=1.8,
             loss_rate=0.15)
INTS = ("n_offload", "n_offload_ok", "n_retries", "n_fallback_local",
        "n_dropped", "n_deadline_miss")


def test_fault_model_validation_matches_reference():
    assert FaultModel.none().is_null()
    assert not FaultModel.make(loss_rate=0.1).is_null()
    assert FaultModel.make(backoff_base=0.1, backoff_cap=0.5).is_null()
    for kw, match in ((dict(loss_rate=1.5), "loss_rate"),
                      (dict(es_crash_prob=-0.1), "es_crash_prob"),
                      (dict(straggler_prob=0.5, straggler_mult=0.5),
                       "straggler_mult"),
                      (dict(link_degrade_mag=-1.0), "link_degrade_mag"),
                      (dict(backoff_base=-0.01), "backoff")):
        with pytest.raises(ValueError, match=match) as got:
            FaultModel.make(**kw)
        with pytest.raises(ValueError, match=match) as want:
            RF.FaultModel.make(**kw)
        assert str(got.value) == str(want.value)
    for kw in (HARSH, {}, dict(loss_rate=0.3, backoff_cap=0.1)):
        ref = RF.FaultModel.make(**kw)
        assert convert.fault_model_from_numpy(ref) == FaultModel.make(**kw)
        assert FaultModel.make(**kw).is_null() == ref.is_null()
    assert convert.fault_model_from_numpy(RF.FaultModel.none()) \
        == FaultModel.none()
    assert serving_faults.FaultModel is FaultModel


def _period_inputs(seed, D=24, n=8, m=2):
    """A random planned period (NumPy): per-sample ES times large enough
    that retries meet the 2T gate, ED walls near the deadline."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(D, n)) < 0.85
    es_samp = mask & (rng.uniform(size=(D, n)) < 0.5)
    acc = np.concatenate(
        [np.sort(rng.uniform(0.3, 0.8, size=(D, m)), axis=1),
         rng.uniform(0.8, 0.95, size=(D, 1))], axis=1)
    acc_jobs = np.where(es_samp, acc[:, [m]], acc[:, 0][:, None]) * mask
    return dict(mask=mask, es_samp=es_samp, acc_jobs=acc_jobs,
                p_es_jobs=rng.uniform(0.05, 0.45, size=(D, n)),
                ed_wall=rng.uniform(0.0, 1.9, size=D),
                lat_local=rng.uniform(0.02, 0.5, size=(D, n, m)), acc=acc)


def _realization(case, seed, D=24, n=8, attempts=3):
    """A concrete realization (NumPy) exercising one rung of the ladder."""
    rng = np.random.default_rng(100 + seed)
    link = np.where(rng.uniform(size=D) < 0.5,
                    1.0 + 0.8 * rng.uniform(size=D), 1.0)
    strag = np.where(rng.uniform(size=D) < 0.3, 1.8, 1.0)
    lost = rng.uniform(size=(D, n, attempts)) < {"crash": 0.0, "loss": 0.5,
                                                 "link": 0.2}[case]
    if case != "link":
        link = np.ones(D)
    return RF.FaultRealization(es_crash=np.bool_(case == "crash"),
                               link_factor=link, straggler_factor=strag,
                               lost=lost)


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _port_realize(fm, real, inputs, T, max_retries):
    return realize_execution(
        fm, FaultRealization(*(_t(np.asarray(x)) for x in real)),
        **{k: _t(v) for k, v in inputs.items()}, T=_t(np.float64(T)),
        max_retries=max_retries)


@pytest.mark.parametrize("case", ["crash", "loss", "link"])
@pytest.mark.parametrize("max_retries", [0, 1, 2])
def test_realize_execution_matches_reference(case, max_retries):
    """The ladder on the same period and realization in both packages."""
    seed = {"crash": 1, "loss": 2, "link": 3}[case] + 10 * max_retries
    inputs = _period_inputs(seed)
    real = _realization(case, seed, attempts=max_retries + 1)
    ref_fm = RF.FaultModel.make(**HARSH)
    T = 1.0
    got = _port_realize(convert.fault_model_from_numpy(ref_fm), real,
                        inputs, T, max_retries)
    with reference_x64():
        want = RF.realize_execution(ref_fm, real, **inputs, T=np.float64(T),
                                    max_retries=max_retries)
        want = [np.asarray(w) for w in want]
    for name, g, w in zip(got._fields, got, want):
        if name in INTS:
            np.testing.assert_array_equal(to_numpy(g), w, err_msg=name)
        else:
            np.testing.assert_allclose(to_numpy(g), w, atol=1e-12, rtol=0,
                                       err_msg=name)
    retries = to_numpy(got.n_retries).sum()
    fallback = to_numpy(got.n_fallback_local).sum()
    if case == "crash":
        assert retries == 0 and to_numpy(got.n_offload_ok).sum() == 0
        assert fallback + to_numpy(got.n_dropped).sum() > 0
    elif max_retries:
        assert retries > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ladder_identity_and_makespan_bound(seed):
    """Drawn realizations of a harsh model (and a certain crash): every
    admitted offload resolves exactly once, retries are bounded, the
    realized ES time stays within 2T + backoff_cap + demand x link, and
    the local fallback fits the residual deadline."""
    inputs = _period_inputs(seed, D=64)
    demand = (inputs["p_es_jobs"] * inputs["es_samp"]).sum(axis=1)
    for fm in (FaultModel.make(**HARSH),
               FaultModel.make(es_crash_prob=1.0, loss_rate=0.3)):
        for max_retries in (0, 3):
            real = sample_realization((seed, 0), fm, 64, 8, max_retries + 1,
                                      device="cpu")
            rx = _port_realize(fm, real, inputs, 1.0, max_retries)
            n_off = to_numpy(rx.n_offload)
            np.testing.assert_array_equal(
                n_off, to_numpy(rx.n_offload_ok)
                + to_numpy(rx.n_fallback_local) + to_numpy(rx.n_dropped))
            assert (to_numpy(rx.n_retries) <= max_retries * n_off).all()
            bound = 2.0 + fm.backoff_cap + demand * to_numpy(
                real.link_factor)
            assert (to_numpy(rx.es_wall) <= bound + 1e-9).all()
            assert (to_numpy(rx.ed_wall) <= np.maximum(
                to_numpy(rx.ed_audit), 2.0) + 1e-9).all()
            if fm.es_crash_prob == 1.0:
                assert not to_numpy(rx.n_retries).any()


def test_null_realization_reproduces_priced_execution():
    """Identity factors and no loss: the realized pass is the priced plan,
    bit for bit — the ES time is the slot-order demand sum the engine
    admits with."""
    from repro_torch.core.problem import slot_sum
    inputs = _period_inputs(4)
    real = sample_realization((4, 0), FaultModel.none(), 24, 8, 3,
                              device="cpu")
    assert not bool(real.es_crash) and bool((real.link_factor == 1).all())
    rx = _port_realize(FaultModel.none(), real, inputs, 1.0, 2)
    demand = slot_sum(_t(np.where(inputs["es_samp"], inputs["p_es_jobs"],
                                  0.0)))
    assert torch.equal(rx.es_wall, demand)
    assert torch.equal(rx.ed_wall, _t(inputs["ed_wall"]))
    assert torch.equal(rx.ed_audit, rx.ed_wall)
    assert torch.equal(rx.acc, _t(inputs["acc_jobs"]))
    assert torch.equal(rx.n_offload, rx.n_offload_ok)
    assert not (rx.n_retries.any() or rx.n_dropped.any()
                or rx.n_fallback_local.any())


def _within(freq, p, n):
    return abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-12


def test_sampler_distribution_and_determinism():
    """The port's own draws, held by distribution (5 standard errors at
    D = 4096) and by determinism."""
    fm = FaultModel.make(**HARSH)
    D, n, A = 4096, 12, 3
    draws = [sample_realization((7, t), fm, D, n, A, device="cpu")
             for t in range(64)]
    crash = np.array([bool(r.es_crash) for r in draws])
    assert _within(crash.mean(), fm.es_crash_prob, crash.size)
    r = draws[0]
    link = to_numpy(r.link_factor)
    degraded = link > 1.0
    assert _within(degraded.mean(), fm.link_degrade_prob, D)
    # magnitude ~ 1 + mag * U(0, 1): mean 1 + mag / 2
    mags = (link[degraded] - 1.0) / fm.link_degrade_mag
    assert (mags >= 0).all() and (mags < 1).all()
    assert abs(mags.mean() - 0.5) <= 5 * np.sqrt(1 / 12 / mags.size)
    strag = to_numpy(r.straggler_factor)
    assert set(np.unique(strag)) <= {1.0, fm.straggler_mult}
    assert _within((strag > 1).mean(), fm.straggler_prob, D)
    lost = to_numpy(r.lost)
    assert lost.shape == (D, n, A)
    assert _within(lost.mean(), fm.loss_rate, lost.size)
    for x in r:
        assert x.dtype in (torch.bool, torch.float64)
    again = sample_realization((7, 0), fm, D, n, A, device="cpu")
    for a, b in zip(r, again):
        assert torch.equal(a, b)
    other = sample_realization((8, 0), fm, D, n, A, device="cpu")
    assert not torch.equal(r.lost, other.lost)
    assert not torch.equal(r.link_factor, other.link_factor)
    null = sample_realization((7, 0), FaultModel.none(), D, n, A,
                              device="cpu")
    assert not bool(null.es_crash) and not null.lost.any()
    assert bool((null.link_factor == 1.0).all())
    assert bool((null.straggler_factor == 1.0).all())
