"""The loss and its gradient (ROADMAP §1 item 12.5) against the reference,
parameters carried over with `convert`: `models.loss_fn` and
`launch.steps.value_and_grad` on the dense and VLM smoke configs in
float32 (loss to rtol 1e-5, each gradient leaf to 1e-4 of its largest
|g|: `test_torch_lm_util.LOSS_RTOL`, `GRAD_TOL`); the sequence-chunked
loss with a remainder, the three remat modes, and the plain chunked and
q-block attention paths (`layers._chunked_attention`,
`_qblock_attention`) against the reference's and the dense path.  The
MoE, SSM, hybrid and encoder-decoder configs are in
`test_torch_loss_families.py`, bfloat16 in `test_torch_loss_bf16.py`.
"""
import dataclasses

import jax  # noqa: F401  (the port's tests import both frameworks)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import layers, loss_fn

import test_torch_lm_util as U

DENSE = ["internlm2_20b", "deepseek_coder_33b", "h2o_danube_1_8b",
         "paper_edge", "gemma3_1b", "internvl2_76b"]
ATTN_TOL = 1e-5              # float32 attention outputs, absolute


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grad_match_reference_float32(arch):
    U.check_loss_float32(arch)


@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
def test_logit_chunk_with_remainder_equals_unchunked(attn_impl):
    """23 label positions in chunks of 5 (4 chunks + a remainder of 3):
    the loss and every gradient leaf equal the unchunked ones to float32
    rounding (1e-6 relative: the sum runs in another order), and the
    reference's chunked loss to the float32 bars."""
    arch = "paper_edge"
    _, cfg = U.cfgs(arch, "float32", attn_impl=attn_impl)
    params = U.port_params(arch, "float32")
    b = U.as_torch(U.batch_np(cfg, U.B, U.S_FWD))
    l0, g0 = value_and_grad(params, b, cfg)
    l1, g1 = value_and_grad(params, b,
                            dataclasses.replace(cfg, logit_chunk=5))
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    U.assert_grads_close({p: g.numpy() for p, g in U.leaves(g1)},
                         {p: g.numpy() for p, g in U.leaves(g0)}, tol=1e-6)
    U.check_loss_float32(arch, attn_impl="dense", logit_chunk=5)


@pytest.mark.parametrize("arch", ["paper_edge", "mamba2_130m",
                                  "granite_moe_1b_a400m"])
def test_remat_modes_give_equal_gradients(arch):
    """remat none, full and dots: one loss, gradients equal (the
    recomputed forward is the same arithmetic; 1e-6 of each leaf's
    largest |g| allows a reordered sum)."""
    _, cfg = U.cfgs(arch, "float32")
    params = U.port_params(arch, "float32")
    b = U.as_torch(U.batch_np(cfg, U.B, U.S_FWD))
    base_l, base_g = value_and_grad(params, b, cfg)
    base = {p: g.numpy() for p, g in U.leaves(base_g)}
    for remat in ("full", "dots"):
        l, g = value_and_grad(params, b, dataclasses.replace(cfg,
                                                             remat=remat))
        assert float(l) == float(base_l), remat
        U.assert_grads_close({p: x.numpy() for p, x in U.leaves(g)}, base,
                             tol=1e-6)


def _qkv(seed, Sq, Sk, H=4, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, S, H, D)).astype(np.float32)
            for S in (Sq, Sk, Sk)]


def _port_chunked(q, k, v, mask, window, chunk, score_dtype=torch.float32):
    q, k, v = (torch.as_tensor(x) for x in (q, k, v))
    qp = torch.arange(q.shape[1], dtype=torch.int32)
    kp = torch.arange(k.shape[1], dtype=torch.int32)
    return layers._chunked_attention(q, k, v, qp, kp, mask, window, chunk,
                                     score_dtype).numpy()


def _dense(q, k, v, mask, window):
    q, k, v = (torch.as_tensor(x) for x in (q, k, v))
    qp = torch.arange(q.shape[1], dtype=torch.int32)
    kp = torch.arange(k.shape[1], dtype=torch.int32)
    return layers._dense_attention(q, k, v, qp, kp, mask, window).numpy()


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask,window", [("causal", 0), ("window", 6),
                                         ("none", 0)])
def test_chunked_attention_matches_reference_and_dense(mask, window,
                                                       score_dtype):
    """24 keys in chunks of 8 (no padding): the port's scan equals the
    reference's (float32 to 1e-5; bfloat16 scores within 2^-7 relative of
    the largest output) and, with float32 scores, the dense path."""
    q, k, v = _qkv(0, 24, 24)
    pos = jnp.arange(24, dtype=jnp.int32)
    want = np.asarray(ref_layers._chunked_attention(
        q, k, v, pos, pos, mask, window, 8,
        score_dtype=jnp.dtype(score_dtype)))
    got = _port_chunked(q, k, v, mask, window, 8,
                        getattr(torch, score_dtype))
    tol = ATTN_TOL if score_dtype == "float32" else \
        2 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if score_dtype == "float32":
        np.testing.assert_allclose(got, _dense(q, k, v, mask, window),
                                   rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("mask,window", [("causal", 0), ("window", 6),
                                         ("none", 0)])
def test_chunked_attention_masks_padded_keys(mask, window):
    """21 keys in chunks of 8 (3 padded): the port equals the dense path.
    The reference gives its padded keys the position -10^9, which its
    causal and unmasked masks keep live (zero keys, zero values that
    still add exp(0 - max) to the softmax's denominator): it differs
    from its own dense path there, and only there (ROADMAP §3)."""
    q, k, v = _qkv(1, 21, 21)
    dense = _dense(q, k, v, mask, window)
    np.testing.assert_allclose(_port_chunked(q, k, v, mask, window, 8),
                               dense, rtol=0, atol=ATTN_TOL)
    pos = jnp.arange(21, dtype=jnp.int32)
    ref = np.asarray(ref_layers._chunked_attention(q, k, v, pos, pos, mask,
                                                   window, 8))
    assert (np.abs(ref - dense).max() > 1e-2) == (mask != "window")


@pytest.mark.parametrize("mask,window", [("causal", 0), ("window", 6)])
def test_qblock_attention_matches_reference_and_dense(mask, window):
    """q blocks of 8 over 32 positions (chunk 8: no padding)."""
    _, cfg = U.cfgs("paper_edge", "float32", q_block=8, attn_chunk=8)
    rcfg, _ = U.cfgs("paper_edge", "float32", q_block=8, attn_chunk=8)
    q, k, v = _qkv(2, 32, 32)
    pos = jnp.arange(32, dtype=jnp.int32)
    want = np.asarray(ref_layers._qblock_attention(q, k, v, pos, pos, mask,
                                                   window, rcfg))
    qt, kt, vt = (torch.as_tensor(x) for x in (q, k, v))
    tpos = torch.arange(32, dtype=torch.int32)
    got = layers._qblock_attention(qt, kt, vt, tpos, tpos, mask, window,
                                   cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATTN_TOL)
    np.testing.assert_allclose(got, _dense(q, k, v, mask, window), rtol=0,
                               atol=ATTN_TOL)


def test_loss_through_chunked_and_qblock_attention_matches_reference():
    """The whole loss and gradient with ``attn_impl="chunked"`` (q blocks
    of 8, chunks of 8 over 24 positions), in float32."""
    U.check_loss_float32("paper_edge", attn_impl="chunked", q_block=8,
                         attn_chunk=8)


def test_loss_fn_matches_value_and_grad_loss():
    """`loss_fn` alone (no autograd) equals the loss of the gradient
    call."""
    _, cfg = U.cfgs("paper_edge", "float32")
    params = U.port_params("paper_edge", "float32")
    b = U.as_torch(U.batch_np(cfg, U.B, U.S_FWD))
    with torch.no_grad():
        plain = float(loss_fn(params, b, cfg))
    assert plain == float(value_and_grad(params, b, cfg)[0])


def test_grad_dtype_barrier_is_identity_with_bfloat16_cotangents():
    """Forward: the same values (a float32 tensor, or one autograd does
    not record, passes through as itself).  Backward: a bfloat16
    cotangent, the upstream's values rounded to bfloat16."""
    x = torch.linspace(-2, 2, 7, dtype=torch.bfloat16, requires_grad=True)
    y = layers.grad_dtype_barrier(x)
    assert torch.equal(y, x) and y is not x
    w = torch.linspace(0.1, 1.3, 7)
    (g,) = torch.autograd.grad((y.float() * w).sum(), x)
    assert g.dtype == torch.bfloat16 and torch.equal(g, w.to(torch.bfloat16))
    f = torch.ones(3, requires_grad=True)
    assert layers.grad_dtype_barrier(f) is f
    with torch.no_grad():
        assert layers.grad_dtype_barrier(x) is x
