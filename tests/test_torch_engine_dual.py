"""The tensor engine under ``policy="dual"`` against the reference's, on
the CPU: `rollout` of `make_fleet(16, seed)` with replayed arrivals, 2
servers, 8 periods.

The audit threshold is 1.4, off the exact tie at 1.5 that a 3x straggler
meets after one EMA update (ROADMAP §3 item 1).  Bar: integer metrics
and state exact, float metrics and state to 1e-9; the warm basis stays
-1 (the dual carries none).
"""
import numpy as np
import pytest
import torch

from repro.api import engine as RE
from repro.serving.fleet import make_fleet as ref_make_fleet
from repro.serving.queue import RequestQueue as RefQueue
from repro_torch.api import engine as PE
from repro_torch.serving.fleet import make_fleet
from repro_torch.serving.queue import RequestQueue
from test_torch_parity_util import reference_x64, to_numpy

# the reference's roofline ES defaults (TPU v5e), passed explicitly
V5E = dict(es_peak_flops=197e12, es_hbm_bw=819e9)
CLASSES = (128, 512, 1024)
D, PERIODS = 16, 8
SHARED_STATE = tuple(f for f in PE.STATE_FIELDS if f != "seed")


def _pair(seed, policy="dual", **kw):
    ref = RE.EngineParams.from_fleet(
        ref_make_fleet(D, seed=seed, horizon=PERIODS),
        RefQueue(D, CLASSES, rate=10.0, batch_max=12, seed=seed),
        T=1.2, n_servers=2, horizon=PERIODS, policy=policy,
        straggler_threshold=1.4, **kw)
    port = PE.EngineParams.from_fleet(
        make_fleet(D, seed=seed, horizon=PERIODS, **V5E),
        RequestQueue(D, CLASSES, rate=10.0, batch_max=12, seed=seed),
        T=1.2, n_servers=2, horizon=PERIODS, policy=policy,
        straggler_threshold=1.4, device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("seed", [3, 11])
def test_dual_rollout_matches_reference(seed):
    ref, port = _pair(seed)
    assert port.iters == ref.iters == 40
    with reference_x64():
        rs, rm = RE.rollout(RE.init_state(ref), ref, PERIODS)
    ps, pm = PE.rollout(PE.init_state(port, device="cpu"), port, PERIODS,
                        device="cpu")
    for f in PE.METRIC_FIELDS:
        a, b = to_numpy(getattr(pm, f)), np.asarray(getattr(rm, f))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in SHARED_STATE:
        a, b = to_numpy(getattr(ps, f)), np.asarray(getattr(rs, f))
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (to_numpy(ps.warm_basis) == -1).all()
    assert int(pm.n_unsolved.sum()) == 0
    # the paths the slice adds ran: backpressure replans, audits
    assert int(pm.n_backpressured.sum()) > 0
    assert int(pm.n_straggler_updates.sum()) > 0


@pytest.mark.parametrize("seed", [3, 11])
def test_dual_step_by_step_equals_rollout_and_keeps_bases_cold(seed):
    _, port = _pair(seed)
    s0 = PE.init_state(port, device="cpu")
    sr, mr = PE.rollout(s0, port, 4, device="cpu")
    s = s0
    for t in range(4):
        s, m = PE.step(s, port, device="cpu")
        assert (s.warm_basis == -1).all()
        for f in PE.METRIC_FIELDS:
            assert torch.equal(getattr(m, f), getattr(mr, f)[t]), f
    for f in PE.STATE_FIELDS:
        assert torch.equal(getattr(s, f), getattr(sr, f)), f
