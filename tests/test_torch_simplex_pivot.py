"""The simplex pivot kernels' plain PyTorch versions against the reference.

`repro_torch.kernels.simplex_pivot.ref` is held against the reference's
jnp oracles (`repro.kernels.simplex_pivot.ref`, jitted as the engine runs
them) and its Pallas kernels in interpret mode, on random, masked,
degenerate and Bland lanes.  The wrappers in `ops` run the plain version on CPU tensors only
(`tests/test_torch_cuda.py` holds the CUDA kernels against it on a card).

Tolerances: integer outputs (bases, flags) exact.  Floats to rtol/atol
1e-12: the port's rank-1 updates round once (fused multiply-add), like
XLA's code for the jnp oracle, but the Pallas body's one-hot sums and the
BTRAN/FTRAN contractions may round the last bit differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.simplex_pivot import ref as jref
from repro.kernels.simplex_pivot.simplex_pivot import (
    reduced_pivot as pallas_reduced_pivot, simplex_pivot as pallas_pivot)
from repro_torch.kernels.simplex_pivot import ops, ref
from test_torch_parity_util import reference_x64, to_numpy

RTOL = ATOL = 1e-12
B, R, C0 = 24, 6, 14       # lanes, rows, columns (fleet shape is 16384, 14, 38)


def _tableau_case(seed):
    """Random (B, R+1, C0+1) tableaus with pivot coordinates; a third of
    the lanes masked, and the masked lanes' (r, j) out of range."""
    rng = np.random.default_rng(seed)
    tabs = rng.normal(size=(B, R + 1, C0 + 1))
    r = rng.integers(0, R, B).astype(np.int32)
    j = rng.integers(0, C0, B).astype(np.int32)
    mask = rng.uniform(size=B) < 0.66
    r[~mask] = 99
    tabs[np.arange(B), r.clip(0, R), j] += np.sign(
        tabs[np.arange(B), r.clip(0, R), j]) * 0.5      # no tiny pivots
    return tabs, r, j, mask


def _reduced_case(seed):
    """Random revised-simplex lanes: some degenerate (zero basic levels,
    artificial labels at level 0), some on Bland's rule, some masked."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, R, C0))
    c = rng.normal(size=(B, C0))
    Binv = np.eye(R)[None] + 0.3 * rng.normal(size=(B, R, R))
    xB = rng.uniform(0.0, 2.0, size=(B, R))
    degenerate = np.arange(B) % 4 == 1
    xB[degenerate, ::2] = 0.0
    basis = np.stack([rng.permutation(C0 + R)[:R] for _ in range(B)]
                     ).astype(np.int32)
    use_bland = np.arange(B) % 3 == 0
    may_pivot = rng.uniform(size=B) < 0.8
    lane_ok = rng.uniform(size=B) < 0.9
    lane_ok[5] = False                   # a masked lane never enters
    return A, c, Binv, xB, basis, use_bland, may_pivot, lane_ok


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pivot_update_ref_matches_reference_and_pallas(seed):
    tabs, r, j, mask = _tableau_case(seed)
    got = ref.pivot_update_ref(_t(tabs), _t(r), _t(j), _t(mask)).numpy()
    rc, jc = r.clip(0, R), j                       # jnp oracle: valid r/j
    with reference_x64():
        want = np.asarray(jax.jit(jref.pivot_update_ref)(
            jnp.asarray(tabs), jnp.asarray(rc), jnp.asarray(jc),
            jnp.asarray(mask)))
        pallas = np.asarray(pallas_pivot(tabs, rc, jc, mask,
                                         interpret=True))
    np.testing.assert_array_equal(got, want)   # jitted: XLA's FMA, as here
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[~mask], tabs[~mask])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("art_cost", [1.0, 0.0])
def test_reduced_pivot_ref_matches_reference_and_pallas(seed, art_cost):
    case = _reduced_case(seed)
    got = ref.reduced_pivot_ref(*map(_t, case), art_cost=art_cost, tol=1e-7)
    with reference_x64():
        want = jax.jit(jref.reduced_pivot_ref,
                       static_argnames=("art_cost", "tol"))(
            *map(jnp.asarray, case), art_cost=art_cost, tol=1e-7)
        pallas = pallas_reduced_pivot(*case, art_cost=art_cost, tol=1e-7,
                                      interpret=True)
    for other in (want, pallas):
        for k, (g, w) in enumerate(zip(got, other)):
            g, w = to_numpy(g), np.asarray(w)
            if k < 2:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"output {k}")
    has_enter, unbounded, degen = (to_numpy(x) for x in got[3:])
    assert has_enter.any() and (~has_enter).any()
    assert degen[has_enter].any()                    # degenerate pivots hit


def test_price_reduced_ref_matches_reference():
    A, c, Binv, _xB, basis, *_ = _reduced_case(7)
    got = ref.price_reduced_ref(_t(A), _t(c), _t(Binv), _t(basis), 1.0)
    with reference_x64():
        want = jref.price_reduced_ref(jnp.asarray(A), jnp.asarray(c),
                                      jnp.asarray(Binv), jnp.asarray(basis),
                                      1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_bland_lanes_take_the_first_eligible_column():
    A, c, Binv, xB, basis, _ub, may, ok = _reduced_case(11)
    bland = np.ones(B, bool)
    Binv2, _x, bas2, has_enter, *_ = ref.reduced_pivot_ref(
        *map(_t, (A, c, Binv, xB, basis, bland, may, ok)), art_cost=1.0,
        tol=1e-7)
    rc = ref.price_reduced_ref(_t(A), _t(c), _t(Binv), _t(basis), 1.0)
    first = ((rc < -1e-7) & _t(ok)[:, None]).to(torch.uint8).argmax(1)
    moved = (bas2 != _t(basis)).any(1)
    entered = torch.where(bas2 != _t(basis), bas2, -1).amax(1)
    assert torch.equal(entered[moved], first[moved].to(torch.int32))


def test_cpu_wrappers_run_plain_version_in_place_without_counting():
    ops.reset_launches()
    tabs, r, j, mask = _tableau_case(5)
    t = _t(tabs)
    out = ops.pivot_update(t, _t(r), _t(j), _t(mask))
    assert out is t
    np.testing.assert_array_equal(
        t.numpy(), ref.pivot_update_ref(_t(tabs), _t(r), _t(j),
                                        _t(mask)).numpy())
    case = [_t(x) for x in _reduced_case(5)]
    want = ref.reduced_pivot_ref(*[x.clone() for x in case], art_cost=1.0,
                                 tol=1e-7)
    flags = ops.reduced_pivot(*case, art_cost=1.0, tol=1e-7)
    for k, got in enumerate((case[2], case[3], case[4]) + tuple(flags)):
        assert torch.equal(got, want[k]), k
    assert ops.pivot_update.launches == 0
    assert ops.reduced_pivot.launches == 0


def test_wrappers_refuse_devices_without_a_kernel():
    meta = torch.empty((2, 3, 4), dtype=torch.float64, device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no simplex_pivot kernel"):
        ops.pivot_update(meta, idx, idx, idx.bool())
