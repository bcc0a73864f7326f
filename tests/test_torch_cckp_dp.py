"""The CCKP kernel's plain version (`repro_torch.kernels.cckp_dp`) against
every reference path of the same DP:

* `repro.kernels.cckp_dp.ref.cckp_model_dp_ref` (the kernel's oracle);
* `repro.core.amdp._model_dp` (the jitted scan `solve_cckp` runs);
* `repro.core.amdp._batch_dp_jnp` (the vmapped traced-shift scan of
  `amdp_batch`, per-lane p, all m models chained);
* `repro.kernels.cckp_dp.cckp_dp.cckp_model_dp` in interpret mode (the
  Pallas kernel itself).

`models_dp` (all m models of one AMDP call in one launch on the card)
runs on the CPU as `cckp_model_dp_ref` chained m times; it is held
against `model_dp` chained and against `_batch_dp_jnp`.

Tolerance: none.  Values are float32 and must be bitwise equal, ``bestq``
exact.  The reference rounds ``s + q*a`` twice (the product, then the
sum); the FMA-sensitive case asserts that its inputs have cells where one
rounding gives another value, so an implementation that contracts to an
FMA fails here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.amdp import _batch_dp_jnp, _model_dp
from repro.kernels.cckp_dp.cckp_dp import cckp_model_dp as pallas_model_dp
from repro.kernels.cckp_dp.ref import cckp_model_dp_ref as jax_ref
from repro_torch.kernels.cckp_dp import ops
from repro_torch.kernels.cckp_dp.ref import NEG, cckp_model_dp_ref

T1, K1 = 64, 16


def _grid(kind, seed, shape=(T1, K1)):
    """float32 value grids: the DP's own start (0 in column 0, NEG
    elsewhere), a NEG-filled grid, or random values."""
    rng = np.random.default_rng(seed)
    if kind == "start":
        y = np.full(shape, NEG, np.float32)
        y[..., 0] = 0.0
    elif kind == "neg":
        y = np.full(shape, NEG, np.float32)
    else:
        y = rng.normal(0.0, 1.0, shape).astype(np.float32)
    return y


def _port(y, p, a, n_steps):
    """The port's plain version on one grid."""
    got_y, got_q = cckp_model_dp_ref(
        torch.as_tensor(y)[None], torch.tensor([p], dtype=torch.int32),
        torch.tensor([a], dtype=torch.float32), n_steps)
    return got_y[0].numpy(), got_q[0].numpy()


def _reference_paths(y, p, a, n_steps):
    """(y', bestq) from the three single-grid reference paths."""
    yj = jnp.asarray(y)
    return {
        "ref.cckp_model_dp_ref": jax_ref(yj, a, p=p, n_steps=n_steps),
        "amdp._model_dp": _model_dp(yj, p, float(a), n_steps),
        "pallas interpret": pallas_model_dp(
            yj, jnp.asarray(a, jnp.float32), p=p, n_steps=n_steps,
            interpret=True),
    }


def _single_rounding(y, p, a, n_steps):
    """The DP with ``s + q*a`` rounded once (an FMA), in float64 then
    rounded to float32; only its values are used."""
    shape = y.shape
    best = np.full(shape, NEG, np.float32)
    t = np.arange(shape[0])
    for q in range(n_steps):
        src = np.full(shape, NEG, np.float32)
        rows = t - q * p
        if q < shape[1]:
            ok = rows >= 0
            src[ok, q:] = y[rows[ok], :shape[1] - q]
        val = (src.astype(np.float64)
               + np.float64(q) * np.float64(a)).astype(np.float32)
        best = np.where(val > best, val, best)
    return best


@pytest.mark.parametrize("case", [
    ("start", 0, 3), ("start", 1, 7), ("random", 0, 3), ("random", 1, 0),
    ("random", 2, 5), ("random", 3, T1), ("random", 4, T1 + 37),
    ("neg", 5, 2)],
    ids=lambda c: f"{c[0]}-p{c[2]}")
def test_plain_version_is_bitwise_equal_to_every_reference(case):
    kind, seed, p = case
    y = _grid(kind, seed)
    a = np.float32(np.random.default_rng(seed + 100).uniform(0.3, 0.99))
    got_y, got_q = _port(y, p, a, K1)
    for name, (want_y, want_q) in _reference_paths(y, p, a, K1).items():
        np.testing.assert_array_equal(got_y, np.asarray(want_y), name)
        np.testing.assert_array_equal(got_q, np.asarray(want_q), name)


def test_single_column_grid():
    """K1 = 1: only q = 0 reads inside the grid."""
    y = _grid("random", 6, (T1, 1))
    got_y, got_q = _port(y, 3, np.float32(0.7), 1)
    for name, (want_y, want_q) in _reference_paths(
            y, 3, np.float32(0.7), 1).items():
        np.testing.assert_array_equal(got_y, np.asarray(want_y), name)
        np.testing.assert_array_equal(got_q, np.asarray(want_q), name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fma_sensitive_grids_round_twice(seed):
    """On random grids an FMA gives other values than the reference's two
    roundings in some cells; the port must give the reference's."""
    y = _grid("random", 10 + seed)
    p = 1 + seed
    a = np.float32(np.random.default_rng(seed).uniform(0.3, 0.99))
    want_y, want_q = _reference_paths(y, p, a, K1)["amdp._model_dp"]
    fma = _single_rounding(y, p, a, K1)
    assert (fma != np.asarray(want_y)).sum() > 0      # the inputs bite
    got_y, got_q = _port(y, p, a, K1)
    np.testing.assert_array_equal(got_y, np.asarray(want_y))
    np.testing.assert_array_equal(got_q, np.asarray(want_q))


def test_batch_with_per_lane_p_matches_vmapped_reference():
    """Every model of `_batch_dp_jnp` in turn, lanes with their own p
    (0, larger than the grid, and in between) and accuracies."""
    B, m = 9, 3
    rng = np.random.default_rng(7)
    y0 = np.full((B, T1, K1), NEG, np.float32)
    y0[:, :, 0] = 0.0
    y0[::3] = rng.normal(0, 1, (3, T1, K1)).astype(np.float32)
    p = rng.integers(0, 9, (B, m)).astype(np.int32)
    p[0, 0], p[1, 1] = 0, T1 + 5
    acc = rng.uniform(0.3, 0.99, (B, m)).astype(np.float32)
    want_y, want_tables = _batch_dp_jnp(jnp.asarray(y0), jnp.asarray(p),
                                        jnp.asarray(acc), n_steps=K1, m=m)
    y = torch.as_tensor(y0)
    for i in range(m):
        y, bestq = cckp_model_dp_ref(y, torch.as_tensor(p[:, i]),
                                     torch.as_tensor(acc[:, i]), K1)
        np.testing.assert_array_equal(bestq.numpy(),
                                      np.asarray(want_tables[i]))
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    y = torch.as_tensor(_grid("random", 8))[None].contiguous()
    p = torch.tensor([2], dtype=torch.int32)
    a = torch.tensor([0.6], dtype=torch.float32)
    ops.reset_launches()
    got = ops.model_dp(y, p, a, K1)
    want = cckp_model_dp_ref(y, p, a, K1)
    assert ops.models_dp.launches == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no cckp_model_dp kernel"):
        ops.model_dp(y.to("meta"), p.to("meta"), a.to("meta"), K1)


def _models_case(seed, m, B=10, T1=48, K1=9):
    """(y, p (B, m) int32, a (B, m) float32): lanes of the DP's start grid
    and of random grids; lanes with p = 0, with p past the grid (only q = 0
    reads inside it), and an infeasible lane (NEG everywhere)."""
    rng = np.random.default_rng(seed)
    y = np.full((B, T1, K1), NEG, np.float32)
    y[:, :, 0] = 0.0
    y[1::3] = rng.normal(0.0, 1.0, (len(range(1, B, 3)), T1, K1))
    y[2] = NEG                                      # infeasible lane
    p = rng.integers(1, 9, (B, m)).astype(np.int32)
    p[0, :] = 0
    p[3, -1] = T1 + 5
    p[4, 0] = 0
    a = rng.uniform(0.3, 0.99, (B, m)).astype(np.float32)
    return torch.as_tensor(y), torch.as_tensor(p), torch.as_tensor(a)


# n_steps below, at and above the grid's K1 = 9
@pytest.mark.parametrize("n_steps", [4, 9, 14])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_models_dp_plain_version_equals_model_dp_chained(m, n_steps):
    y, p, a = _models_case(m * 10 + n_steps, m)
    ops.reset_launches()
    got_y, got_q = ops.models_dp(y, p, a, n_steps)
    assert ops.models_dp.launches == 0              # the plain version ran
    assert got_q.shape == (m,) + tuple(y.shape)
    assert got_y.dtype == torch.float32 and got_q.dtype == torch.int32
    want_y = y
    for i in range(m):
        want_y, want_q = ops.model_dp(want_y, p[:, i].contiguous(),
                                      a[:, i].contiguous(), n_steps)
        assert torch.equal(got_q[i], want_q), i
    assert torch.equal(got_y, want_y)
    # the infeasible lane stays infeasible, the others reach a value
    assert (got_y[2] == NEG).all() and (got_y[0, :, 0] == 0.0).all()
    assert (got_q > 0).any()


@pytest.mark.parametrize("m", [1, 2, 3])
def test_models_dp_matches_vmapped_reference(m):
    """All m models at once against the reference's `_batch_dp_jnp`, the
    vmapped traced-shift scan `amdp_batch` runs."""
    y, p, a = _models_case(40 + m, m)
    want_y, want_tables = _batch_dp_jnp(
        jnp.asarray(y.numpy()), jnp.asarray(p.numpy()),
        jnp.asarray(a.numpy()), n_steps=y.shape[2], m=m)
    got_y, got_q = ops.models_dp(y, p, a, y.shape[2])
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_tables))


def test_models_dp_with_no_model_returns_the_grid():
    y, p, a = _models_case(7, 1)
    got_y, got_q = ops.models_dp(y, p[:, :0], a[:, :0], 9)
    assert torch.equal(got_y, y) and got_y is not y
    assert got_q.shape == (0,) + tuple(y.shape)


# (B, T1, K1, m) -> (instance, smem, rows, units) on an H100 (132 SMs, a
# block's opt-in shared memory 232,448 bytes).  The many-lane instance's
# bytes: three buffers of the lane's cells plus 12 bytes, rounded to 16,
# sixteen walking warps' stages of 32 rows of counts, 4 mbarriers and 3
# tickets; the split one's units: models x lanes x row blocks (8 warps x
# rows) x column blocks of 32.
LANES_1201_13 = 3 * 62464 + 16 * 32 * 13 * 4 + 48


@pytest.mark.parametrize("shape,want", [
    # serve's calls (plans of 4,501-6,884 lanes, replans of ~8,000) and
    # the fleet shape: the many-lane instance, one CTA an SM
    ((4501, 1201, 13, 2), ("lanes", LANES_1201_13, 0, 4501)),
    ((8003, 1201, 13, 2), ("lanes", LANES_1201_13, 0, 8003)),
    ((16384, 1201, 13, 2), ("lanes", LANES_1201_13, 0, 16384)),
    # fewer lanes than SMs, down to two: still one SM a lane
    ((133, 1201, 13, 2), ("lanes", LANES_1201_13, 0, 133)),
    ((131, 1201, 13, 2), ("lanes", LANES_1201_13, 0, 131)),
    ((2, 326, 17, 2), ("lanes", 3 * 22192 + 16 * 32 * 17 * 4 + 48, 0, 2)),
    # one lane: alone on an SM when small and compiled (lm_serve's
    # grids), else over the whole card
    ((1, 326, 9, 2), ("lanes", 3 * 11760 + 16 * 32 * 9 * 4 + 48, 0, 1)),
    ((1, 326, 17, 2), ("split", 0, 1, 2 * 41)),
    ((1, 1201, 13, 2), ("split", 0, 1, 2 * 151)),
    ((1, 1201, 25, 2), ("split", 0, 1, 2 * 151)),
    ((1, 20000, 1, 2), ("split", 0, 1, 2 * 2500)),
    # the example's B = 1 grids and the 4 x 4001 x 301 grid
    ((1, 2001, 26, 2), ("split", 0, 1, 2 * 251)),
    ((1, 4001, 90, 2), ("split", 0, 1, 2 * 501 * 3)),
    ((1, 8001, 279, 2), ("split", 0, 2, 2 * 501 * 9)),
    ((4, 4001, 301, 2), ("split", 0, 4, 2 * 4 * 126 * 10)),
    # many lanes whose three grids overflow shared memory
    ((16384, 1201, 25, 2), ("split", 0, 4, 2 * 16384 * 38)),
    # no model: the split instance's units copy the grid once
    ((1, 2001, 26, 0), ("split", 0, 1, 251)),
])
def test_shared_instance_is_chosen_by_shape(shape, want):
    """`ops.plan`, the wrapper's one choice of instance: the many-lane
    instance when three of its grids fit a block's shared memory and
    there are two lanes or more, or one of at most 8192 cells and a
    compiled K1; else the split one over the whole card, its warps
    holding the most rows that still give every SM 32 units of a
    model."""
    B, T1, K1, m = shape
    got = ops.plan(B, T1, K1, m, sms=132, max_smem=232448)
    assert tuple(got) == want
    assert got.smem == ops.smem_bytes(got.instance, T1, K1)
    assert got.smem <= 232448


def test_stamps_go_into_the_kernel_source():
    """`time_kernels.py --kernel cckp --phases` builds the kernel with its
    stamps on: the source's own ``CCKP_STAMPS`` hooks, the stamp buffer
    and its C entries in at the source's marker, once."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import time_kernels
    finally:
        sys.path.remove(str(root))
    text = ops.LIBRARY.src.read_text()
    stamped = time_kernels.stamped_source(text)
    assert stamped.startswith("#define CCKP_STAMPS 1\n")
    assert "// CCKP_STAMP_DECL" not in stamped
    assert stamped.count("cckp_stamps_read") == 1
    assert stamped.count("stamp_write(") == 2      # defined, then called
