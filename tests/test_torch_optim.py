"""The optimizers against the reference (`repro.optim`): `adamw_update`
with the global-norm clip active and inactive, `cosine_schedule` at every
step of a short schedule, and `adafactor_update` on vector, matrix and
stacked (cycles, d_in, d_out) leaves, each over several steps from the
same float32 trees, to rtol 1e-6 (a float32 update computed in one order
in both packages; `pow` and `cos` may differ in the last ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as ref_optim
from repro_torch import _tree
from repro_torch import optim

RTOL, ATOL = 1e-6, 1e-9


def _tree_np(seed, scale=1.0):
    """A tree like a model's: dicts (keys out of order) and a tuple, with
    vector, matrix and stacked leaves."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"w": r(4, 6), "b": r(6),
            "blocks": ({"z": r(3, 4, 6), "a": r(5)}, {"k": r(2, 7)})}


def _jnp(t):
    return jax.tree.map(jnp.asarray, t)


def _torch(t):
    return jax.tree.map(torch.as_tensor, t)


def _assert_tree_close(got, want):
    flat_g, dg = _tree.flatten(got)
    flat_w, dw = jax.tree_util.tree_flatten(want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("clip_active", [True, False])
def test_adamw_matches_reference_over_steps(clip_active):
    """Four steps under the cosine schedule; grads of norm ~20 (clipped
    to 1) or ~0.02 (the clip inactive)."""
    p_np = _tree_np(0)
    rp, pp = _jnp(p_np), _torch(p_np)
    rs, ps = ref_optim.adamw_init(rp), optim.adamw_init(pp)
    rlr = ref_optim.cosine_schedule(3e-2, warmup=2, total=6)
    plr = optim.cosine_schedule(3e-2, warmup=2, total=6)
    scale = 3.0 if clip_active else 0.003
    for step in range(4):
        g_np = _tree_np(10 + step, scale)
        norm = float(ref_optim.global_norm(_jnp(g_np)))
        assert (norm > 1.0) == clip_active
        np.testing.assert_allclose(float(optim.global_norm(_torch(g_np))),
                                   norm, rtol=RTOL)
        rp, rs = ref_optim.adamw_update(_jnp(g_np), rs, rp, lr=rlr)
        pp, ps = optim.adamw_update(_torch(g_np), ps, pp, lr=plr)
        assert int(ps.step) == int(rs.step) == step + 1
        assert ps.step.dtype == torch.int32
        _assert_tree_close(pp, rp)
        _assert_tree_close(ps.m, rs.m)
        _assert_tree_close(ps.v, rs.v)


def test_adamw_constant_lr_and_bfloat16_leaf():
    """A number as lr; a bfloat16 parameter is updated in float32 and cast
    back, its moments float32."""
    p_np = {"x": np.linspace(-1, 1, 8, dtype=np.float32)}
    g_np = {"x": np.linspace(0.5, -0.3, 8, dtype=np.float32)}
    rp = {"x": jnp.asarray(p_np["x"]).astype(jnp.bfloat16)}
    pp = {"x": torch.as_tensor(p_np["x"]).to(torch.bfloat16)}
    rp2, rs = ref_optim.adamw_update(_jnp(g_np), ref_optim.adamw_init(rp),
                                     rp, lr=0.1)
    pp2, ps = optim.adamw_update(_torch(g_np), optim.adamw_init(pp), pp,
                                 lr=0.1)
    assert pp2["x"].dtype == torch.bfloat16 and ps.m["x"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        pp2["x"].float().numpy(), np.asarray(rp2["x"].astype(jnp.float32)))
    _assert_tree_close(ps.v, rs.v)


def test_cosine_schedule_matches_reference_at_every_step():
    for warmup, total in ((3, 10), (1, 4), (0, 5)):
        rlr = ref_optim.cosine_schedule(1e-3, warmup, total)
        plr = optim.cosine_schedule(1e-3, warmup, total)
        for step in range(total + 3):
            want = float(rlr(jnp.asarray(step, jnp.int32)))
            got = plr(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=RTOL,
                                       atol=1e-12)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adafactor_matches_reference_over_steps(weight_decay):
    """Five steps; second moments factored over the last two axes of the
    matrix and stacked leaves, full on the vectors."""
    p_np = _tree_np(1)
    rp, pp = _jnp(p_np), _torch(p_np)
    rs, ps = ref_optim.adafactor_init(rp), optim.adafactor_init(pp)
    assert tuple(ps.vr["blocks"][0]["z"].shape) == (3, 4)
    assert tuple(ps.vc["blocks"][0]["z"].shape) == (3, 6)
    assert tuple(ps.vc["b"].shape) == ()
    for step in range(5):
        g_np = _tree_np(20 + step, 0.5)
        rp, rs = ref_optim.adafactor_update(_jnp(g_np), rs, rp, lr=1e-2,
                                            weight_decay=weight_decay)
        pp, ps = optim.adafactor_update(_torch(g_np), ps, pp, lr=1e-2,
                                        weight_decay=weight_decay)
        _assert_tree_close(pp, rp)
        _assert_tree_close(ps.vr, rs.vr)
        _assert_tree_close(ps.vc, rs.vc)


def test_tree_flatten_follows_jax_order():
    """`_tree.flatten` lists leaves as `jax.tree_util.tree_flatten`: dict
    keys sorted, tuples and NamedTuple fields in order, None empty."""
    tree = ({"b": 1, "a": (2, None, [3])},
            optim.AdamWState(step=4, m={"y": 5, "x": 6}, v=()))
    got, treedef = _tree.flatten(tree)
    assert got == jax.tree_util.tree_flatten(tree)[0] == [2, 3, 1, 4, 6, 5]
    assert _tree.unflatten(treedef, got) == tree
