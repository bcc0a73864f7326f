"""The MoE LMs of the port — granite-moe-1b-a400m and granite-moe-3b-a800m
— and their FFN (`layers.moe_apply`) against the reference's, on the CPU.

* Top-k ties: `layers.top_k` returns `jax.lax.top_k`'s indices (value
  descending, ties to the lower index) on constructed rows, the row
  [0.1, 0.3, 0.3, 0.2, 0.3] among them, where `torch.topk` may not; and
  the router itself, given duplicate columns (exactly tied experts),
  routes as the reference's `moe_apply` does (its `jax.lax.top_k` call
  recorded through a stand-in).
* Dispatch sizes: `moe_groups` (groups, tokens a group, capacity) at the
  SMOKE test size (48 tokens: 16 groups of 3, capacity 2, so tokens are
  dropped) and at the full configurations' 2 x 2048 tokens (32 groups of
  128; capacity 40 for 32 experts, 32 for 40).
* `moe_apply` on the same normed h and expert weights (the reference's
  `init_params`), float32: the expert indices and the kept mask exactly
  the reference's (its indices recorded, its kept mask recomputed from
  them by its own cumsum formula), some pairs dropped, the output to
  5e-5; the one-position decode path (gathered experts, no capacity) to
  5e-5.  bfloat16: the router's product rounds to bfloat16 in both
  packages, but their logits still differ in the last bits, so a near
  tie at the k-th place may go to another expert; measured on these
  inputs: 0 flipped (token, k) pairs of 96 for either model, the output
  within 4.9e-4 max and 4.6e-5 mean (1b; 3b: 1.8e-4, 1.9e-5), the decode
  path within 4.9e-4 (1.2e-4).  The test bounds flips at 5% and the
  output on tokens whose routing agrees at 2^-7 max, 2^-11 mean (decode:
  2^-7 max on at least 75% of tokens routed alike).
* The models: configurations field for field; forward (reference dense
  and Pallas in interpret mode, port dense and flash), prefill, decode on
  the reference's cache, own prefill + decode against own forward with
  ``capacity_factor=8`` (no drops) at the reference's MoE bar of 0.05
  (`tests/test_archs.py`); `init_params` / `init_cache` layouts.
  Tolerances as `tests/test_torch_lm_dense.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as ref_layers
import test_torch_lm_util as U
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers

ARCHS = ("granite_moe_1b_a400m", "granite_moe_3b_a800m")
DTYPES = ("float32", "bfloat16")


# ---------------------------------------------------------------------------
# top-k in lax.top_k's order
# ---------------------------------------------------------------------------
TIE_ROWS = [
    [0.1, 0.3, 0.3, 0.2, 0.3],
    [0.25, 0.25, 0.25, 0.25],
    [0.0, 0.5, 0.0, 0.5, 0.0, 0.0],
    [1.0, 1.0, 0.5, 1.0, 0.5, 0.5, 1.0, 0.25],
]


@pytest.mark.parametrize("row", TIE_ROWS)
def test_top_k_matches_lax_top_k_on_ties(row):
    probs = np.asarray(row, np.float32)
    for k in range(1, len(row) + 1):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = layers.top_k(torch.as_tensor(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    _, wi = jax.lax.top_k(jnp.asarray([0.1, 0.3, 0.3, 0.2, 0.3]), 2)
    assert np.asarray(wi).tolist() == [1, 2]


def test_top_k_matches_lax_top_k_on_many_ties():
    """Rows of 40 values drawn from 5 levels (many ties), k = 8."""
    probs = np.random.default_rng(0).integers(
        0, 5, (512, 40)).astype(np.float32) / 4
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 8)
    gv, gi = layers.top_k(torch.as_tensor(probs), 8)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# ---------------------------------------------------------------------------
# dispatch sizes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,N,want", [
    ("granite_moe_1b_a400m", 48, (16, 3, 2)),
    ("granite_moe_3b_a800m", 48, (16, 3, 2)),
    ("granite_moe_1b_a400m", 2 * 2048, (32, 128, 40)),
    ("granite_moe_3b_a800m", 2 * 2048, (32, 128, 32)),
    ("granite_moe_1b_a400m", 4 * 1000, (32, 125, 40)),
    ("granite_moe_1b_a400m", 24, (24, 1, 2)),
    ("granite_moe_1b_a400m", 6, (6, 1, 2)),
])
def test_moe_groups_and_capacity(arch, N, want):
    rcfg, cfg = U.cfgs(arch, "float32")
    if N >= 2048:
        cfg = get_config(arch)
    assert layers.moe_groups(N, cfg) == want


# ---------------------------------------------------------------------------
# moe_apply against the reference's
# ---------------------------------------------------------------------------
def _moe_inputs(arch, dtype, n_seq, seq, tie=False):
    """(reference layer params, port layer params, h as numpy float32):
    the first layer's FFN leaves of the reference's `init_params`; with
    ``tie`` the router's column 1 copies column 0 and column 3 column 2,
    so those experts tie exactly for every token."""
    rcfg, cfg = U.cfgs(arch, dtype)
    rp = {k: v[0] for k, v in U.ref_params(arch, dtype)["blocks"][0].items()}
    if tie:
        r = np.array(rp["router"])
        r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
        rp = dict(rp, router=jnp.asarray(r))
    pp = convert.model_params_from_numpy(jax.tree.map(np.asarray, rp),
                                         "cpu")
    h = np.random.default_rng(7).standard_normal(
        (n_seq, seq, rcfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, pp, h


def _ref_moe(rp, h, rcfg, monkeypatch):
    """The reference's `moe_apply` and the (gates, experts) its
    `jax.lax.top_k` call returned."""
    seen = []
    real = jax.lax.top_k

    def spy(x, k):
        out = real(x, k)
        seen.append(tuple(np.asarray(o) for o in out))
        return out

    monkeypatch.setattr(jax.lax, "top_k", spy)
    y = ref_layers.moe_apply(rp, jnp.asarray(h).astype(rcfg.dtype), rcfg)
    monkeypatch.setattr(jax.lax, "top_k", real)
    assert len(seen) == 1
    return np.asarray(jnp.asarray(y).astype(jnp.float32)), seen[0]


def _ref_keep(idx, Gr, cap, E):
    """The reference's kept mask, by its formula (`layers.py` one_group):
    the float32 cumsum of the one-hot over the group's (token, k) order."""
    e_flat = jnp.asarray(idx).reshape(Gr, -1)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.float32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    pos_in_e = jnp.take_along_axis(pos, e_flat[..., None], axis=2)[..., 0]
    return np.asarray(pos_in_e.astype(jnp.int32) < cap)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routing_and_drops_match_reference_float32(arch, tie,
                                                       monkeypatch):
    rcfg, cfg, rp, pp, h = _moe_inputs(arch, "float32", U.B, U.S_FWD, tie)
    want, (wg, wi) = _ref_moe(rp, h, rcfg, monkeypatch)
    x = torch.as_tensor(h).reshape(-1, cfg.d_model)
    gates, idx = layers.moe_route(pp, x, cfg)
    np.testing.assert_array_equal(idx.numpy(), wi)
    wg = wg / np.maximum(wg.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(gates.numpy(), wg, rtol=1e-6, atol=1e-7)
    if tie:     # experts 0 and 1 (2 and 3) tie: 1 never ahead of 0
        assert ((wi == 0) | (wi == 1)).any()
        for row in wi.tolist():
            if 0 in row and 1 in row:
                assert row.index(0) < row.index(1)
    Gr, _Nl, cap = layers.moe_groups(x.shape[0], cfg)
    _e, _slot, keep = layers.moe_slots(idx, Gr, cap, cfg.num_experts)
    np.testing.assert_array_equal(keep.numpy(),
                                  _ref_keep(wi, Gr, cap, cfg.num_experts))
    assert not keep.all()                          # the SMOKE size drops
    got = layers.moe_apply(pp, torch.as_tensor(h), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=U.F32_ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_path_matches_reference(arch, dtype, monkeypatch):
    """One position (S = 1): each token's K experts gathered, no drop."""
    rcfg, cfg, rp, pp, h = _moe_inputs(arch, dtype, 4, 1)
    want, (_wg, wi) = _ref_moe(rp, h, rcfg, monkeypatch)
    got = layers.moe_apply(pp, torch.as_tensor(h).to(getattr(torch, dtype)),
                           cfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == (4, 1,
                                                                cfg.d_model)
    _g, idx = layers.moe_route(pp, torch.as_tensor(h).reshape(4, -1).to(
        got.dtype), cfg)
    if dtype == "float32":
        np.testing.assert_array_equal(idx.numpy(), wi)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=U.F32_ATOL)
    else:
        same = (idx.numpy() == wi).all(-1)
        err = np.abs(got.float().numpy() - want)[same]
        assert same.mean() >= 0.75 and err.max() <= 2.0 ** -7


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bfloat16_matches_reference_within_routing_flips(arch,
                                                            monkeypatch):
    rcfg, cfg, rp, pp, h = _moe_inputs(arch, "bfloat16", U.B, U.S_FWD)
    want, (_wg, wi) = _ref_moe(rp, h, rcfg, monkeypatch)
    hb = torch.as_tensor(h).to(torch.bfloat16)
    _g, idx = layers.moe_route(pp, hb.reshape(-1, cfg.d_model), cfg)
    flips = int((idx.numpy() != wi).sum())
    assert flips <= 0.05 * wi.size, flips
    got = layers.moe_apply(pp, hb, cfg).float().numpy()
    same = (idx.numpy() == wi).all(-1).reshape(U.B, U.S_FWD)
    err = np.abs(got - want)[same]
    assert err.max() <= 2.0 ** -7 and err.mean() <= 2.0 ** -11, \
        (err.max(), err.mean())


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, name):
    U.check_config(arch, name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ref_impl,port_impl", [
    ("dense", "dense"), ("dense", "auto"), ("pallas", "auto")])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, ref_impl, port_impl, dtype):
    U.check_forward(arch, ref_impl, port_impl, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    U.check_prefill(arch)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_on_reference_cache_matches_reference(arch, dtype):
    U.check_decode_on_ref_cache(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_own_prefill_decode_matches_own_forward(arch, dtype):
    errs = U.own_generation_errors(arch, dtype, capacity_factor=8.0)
    assert max(errs) <= 0.05, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_in_reference_layout(arch):
    U.check_init_layout(arch)


def test_moe_params_are_the_reference_leaves():
    """The FFN leaves of a MoE layer: router (D, E), experts stacked."""
    _, cfg = U.cfgs("granite_moe_3b_a800m", "float32")
    defs = layers.ffn_param_defs(cfg, "moe")
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    assert {k: shape for k, (shape, _ax) in defs.items()} == {
        "fnorm": (D,), "router": (D, E), "we_gate": (E, D, F),
        "we_up": (E, D, F), "we_down": (E, F, D)}
