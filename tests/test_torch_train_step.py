"""The train step and the int8 gradient compressor against the reference
(ROADMAP §1 item 12.5).

`launch.steps.make_train_step` with one and two microbatches over three
steps from the reference's parameters (carried with `convert`), float32
compute, against the reference's jitted step on the same batches: the
loss to rtol 1e-5; every parameter within 1.5e-4 = lr / 20 of the
reference's (an element whose gradient lies within float32 rounding of
zero takes an Adam step of another size; measured at most 4.2e-5) and
all but 1e-4 of them within 1e-5; the moments likewise, scaled.
`distributed.compression`: `quantize_int8` exactly (int8 values, the
scale, ties rounded to even), `compress_tree` and `EFCompressor` bit for
bit over three steps (the same float32 operations in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.compression as ref_comp
from repro.launch import steps as ref_steps
from repro.optim import adamw_init as ref_adamw_init
from repro_torch import _tree
from repro_torch.distributed import (EFCompressor, compress_tree,
                                     dequantize_int8, quantize_int8)
from repro_torch.launch import steps
from repro_torch.models import param_shapes
from repro_torch.optim import adamw_init

import test_torch_lm_util as U

LR = 3e-3
PARAM_ATOL, PARAM_TIGHT, LOOSE_SHARE = LR / 20, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Smoke-sized steps: one intra-op thread (as fast alone, and no
    oversubscription when several test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _assert_tree_near(got, want, atol, tight):
    n_loose = n_all = 0
    for (p, g), (q, w) in zip(U.leaves(got), U.leaves(want)):
        assert p == q
        d = np.abs(g.numpy() - np.asarray(w))
        assert float(d.max()) <= atol, (p, float(d.max()))
        n_loose += int((d > tight).sum())
        n_all += d.size
    assert n_loose <= LOOSE_SHARE * n_all, (n_loose, n_all)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["paper_edge", "mamba2_130m"])
def test_train_step_matches_reference(arch, microbatches):
    rcfg, cfg = U.cfgs(arch, "float32", microbatches=microbatches)
    rp, pp = U.ref_params(arch, "float32"), U.port_params(arch, "float32")
    rstep = jax.jit(ref_steps.make_train_step(rcfg, lr=LR))
    pstep = steps.make_train_step(cfg, lr=LR)
    ro, po = ref_adamw_init(rp), steps.init_train_state(cfg, pp)
    for s in range(3):
        b = U.batch_np(rcfg, 4, 16, seed=s)
        rp, ro, rl = rstep(rp, ro, U.as_jnp(b))
        pp, po, pl = pstep(pp, po, U.as_torch(b))
        assert pl.dtype == torch.float32 and not pl.requires_grad
        assert abs(float(pl) - float(rl)) <= 1e-5 * abs(float(rl))
        assert int(po.step) == s + 1
        _assert_tree_near(pp, jax.tree.map(np.asarray, rp), PARAM_ATOL,
                          PARAM_TIGHT)
    # first moments are (1 - b1)-weighted gradients: scale the bars by it
    _assert_tree_near(po.m, jax.tree.map(np.asarray, ro.m), 1e-4, 1e-6)


def test_microbatches_average_the_full_batch():
    """M = 2 gives the loss and update of the whole batch (the mean of
    the two halves' means: equal halves, equal token counts)."""
    _, cfg = U.cfgs("paper_edge", "float32")
    _, cfg2 = U.cfgs("paper_edge", "float32", microbatches=2)
    pp = U.port_params("paper_edge", "float32")
    b = U.as_torch(U.batch_np(cfg, 4, 16, seed=9))
    p1, _, l1 = steps.make_train_step(cfg, lr=LR)(pp, adamw_init(pp), b)
    p2, _, l2 = steps.make_train_step(cfg2, lr=LR)(pp, adamw_init(pp), b)
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
    _assert_tree_near(p2, jax.tree.map(lambda t: t.numpy(), p1),
                      PARAM_ATOL, PARAM_TIGHT)


def test_grad_tx_hook_sees_float32_gradients_of_the_params_shape():
    _, cfg = U.cfgs("mamba2_130m", "float32")
    pp = U.port_params("mamba2_130m", "float32")
    seen = []

    def tx(g):
        seen.append(g)
        return g
    b = U.as_torch(U.batch_np(cfg, 2, 16))
    steps.make_train_step(cfg, lr=LR, grad_tx=tx)(pp, adamw_init(pp), b)
    (g,) = seen
    shapes = {p: tuple(t.shape) for p, t in U.leaves(param_shapes(cfg))}
    assert {p: tuple(t.shape) for p, t in U.leaves(g)} == shapes
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all()
               for _p, t in U.leaves(g))


def test_eval_step_runs_without_grad_and_equals_loss():
    _, cfg = U.cfgs("paper_edge", "float32")
    pp = U.port_params("paper_edge", "float32")
    b = U.as_torch(U.batch_np(cfg, 2, 16))
    ev = steps.make_eval_step(cfg)(pp, b)
    assert not ev.requires_grad
    assert float(ev) == float(steps.value_and_grad(pp, b, cfg)[0])


def test_quantize_int8_exact():
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal(1000).astype(np.float32) * 3,
             # x / scale lands on halves: ties round to even
             np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 127.0, -126.5],
                      np.float32),
             np.zeros(4, np.float32),
             rng.standard_normal((3, 5, 7)).astype(np.float32) * 1e-6]
    for x in cases:
        rq, rs = ref_comp.quantize_int8(jnp.asarray(x))
        q, s = quantize_int8(torch.as_tensor(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs) and s.dtype == torch.float32
        np.testing.assert_array_equal(
            dequantize_int8(q, s).numpy(),
            np.asarray(ref_comp.dequantize_int8(rq, rs)))
    q, _ = quantize_int8(torch.as_tensor(cases[1]))
    assert q.tolist() == [0, 2, 2, 0, -2, 4, 127, -126]


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blocks": ({"b": rng.standard_normal(7).astype(np.float32)},)}


def test_compress_tree_and_error_feedback_bit_for_bit():
    ref_err = err = None
    ef = EFCompressor()
    for step in range(3):
        g = _grads(step)
        rout, ref_err = ref_comp.compress_tree(jax.tree.map(jnp.asarray, g),
                                               ref_err)
        tg = jax.tree.map(torch.as_tensor, g)
        out, err = compress_tree(tg, err)
        via_ef = ef(tg)
        for tree, want in ((out, rout), (err, ref_err), (via_ef, rout),
                           (ef.error, ref_err)):
            for (p, a), (q, b) in zip(U.leaves(tree),
                                      U.leaves(jax.tree.map(np.asarray,
                                                            want))):
                assert p == q
                np.testing.assert_array_equal(a.numpy(), b, err_msg=p)


def test_prefill_and_decode_step_factories_match_the_model_calls():
    """`make_prefill_step` / `make_decode_step` run `prefill` and
    `decode_step` without autograd: the same logits and cache as the
    direct calls, nothing recorded."""
    from repro_torch.models import decode_step, prefill
    _, cfg = U.cfgs("mamba2_130m", "float32")
    pp = U.port_params("mamba2_130m", "float32")
    for t in _tree.leaves(pp):
        t.requires_grad_(True)
    b = U.as_torch(U.batch_np(cfg, 2, 12))
    cache, lg = steps.make_prefill_step(cfg, 16)(pp, b)
    with torch.no_grad():
        want_cache, want_lg = prefill(pp, b, cfg, max_seq=16)
    assert not lg.requires_grad and torch.equal(lg, want_lg)
    tok = b["tokens"][:, -1:]
    lg2, cache = steps.make_decode_step(cfg)(pp, tok, cache)
    with torch.no_grad():
        want2, _ = decode_step(pp, tok, want_cache, cfg)
    assert not lg2.requires_grad and torch.equal(lg2, want2)
    assert cache["index"] == 13


def test_prefetcher_yields_the_pipeline_in_step_order():
    """`data.pipeline.Prefetcher` from step 3: (step, batch) pairs equal to
    `batch_at` (and to the reference's tokens), then stops on close."""
    from repro.data.pipeline import DataConfig as RefConfig
    from repro.data.pipeline import TokenPipeline as RefPipeline
    from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                           TokenPipeline)
    pipe = TokenPipeline(DataConfig(vocab_size=100, seq_len=16,
                                    global_batch=2, seed=4))
    ref = RefPipeline(RefConfig(vocab_size=100, seq_len=16, global_batch=2,
                                seed=4))
    pre = Prefetcher(pipe, start_step=3)
    try:
        for want_step in range(3, 7):
            step, batch = pre.next()
            assert step == want_step
            np.testing.assert_array_equal(batch["tokens"],
                                          pipe.batch_at(step)["tokens"])
            np.testing.assert_array_equal(batch["tokens"],
                                          ref.batch_at(step)["tokens"])
    finally:
        pre.close()
    assert not pre._thread.is_alive()
