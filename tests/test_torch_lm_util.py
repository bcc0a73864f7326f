"""Shared parity machinery of the LM family tests (`test_torch_lm_*.py`,
`test_torch_moe.py`): a SMOKE model of either package in one dtype, the
reference's `init_params` carried across with `convert`, inputs made from
numpy seeds (tokens; a VLM's patch embeddings and an encoder-decoder's
frame embeddings, float32, each package casting them to its compute
dtype), and the logit bars of `tests/test_torch_models.py`.

No tests here: the families' files import it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as ref_configs
import repro.models as ref_models
from repro_torch import configs, convert
from repro_torch.models import (decode_step, forward, logits_from_h,
                                prefill)

F32_ATOL = 5e-5
BF16_ATOL, BF16_MEAN, BF16_TOP1 = 0.25, 0.02, 0.85
B, S_FWD = 2, 24                     # forwards: 2 x 24 tokens
S, EXTRA = 12, 4                     # generation: prompt 12, 4 steps
MAX_SEQ = S + EXTRA


def cfgs(arch, dtype, **kw):
    """(reference config, port config) of ``arch``'s SMOKE model in
    ``dtype``; float32 keeps a float32 KV cache unless the model's is
    float8 (internvl2), which both packages keep."""
    base = ref_configs.get_smoke_config(arch)
    extra = dict(dtype=dtype, **kw)
    if dtype == "float32" and "float8" not in base.kv_cache_dtype:
        extra.setdefault("kv_cache_dtype", "float32")
    return (dataclasses.replace(base, **extra),
            dataclasses.replace(configs.get_smoke_config(arch), **extra))


def batch_np(cfg, n_seq, seq, seed=0):
    """numpy inputs: tokens (n_seq, seq) int32, and float32 patch or frame
    embeddings where the model takes them."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size,
                                (n_seq, seq)).astype(np.int32)}
    if cfg.num_patches:
        b["patch_embeds"] = rng.standard_normal(
            (n_seq, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["audio_feats"] = rng.standard_normal(
            (n_seq, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return b


def as_jnp(b, tokens=slice(None)):
    return {k: jnp.asarray(v[:, tokens] if k == "tokens" else v)
            for k, v in b.items()}


def as_torch(b, tokens=slice(None)):
    return {k: torch.as_tensor(v[:, tokens] if k == "tokens" else v)
            for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def ref_params(arch, dtype, **kw):
    rcfg, _ = cfgs(arch, dtype, **kw)
    return ref_models.init_params(rcfg, jax.random.key(1))


def port_params(arch, dtype, **kw):
    return convert.model_params_from_numpy(
        jax.tree.map(np.asarray, ref_params(arch, dtype, **kw)), device="cpu")


@functools.lru_cache(maxsize=None)
def ref_forward(arch, dtype, ref_impl, **kw):
    """The reference's float32 logits of the 2 x 24 forward."""
    rcfg, _ = cfgs(arch, dtype, attn_impl=ref_impl, **kw)
    params = ref_params(arch, dtype, **kw)
    b = batch_np(rcfg, B, S_FWD)
    h = ref_models.forward(params, as_jnp(b), rcfg)
    return np.asarray(ref_models.logits_from_h(params, h, rcfg))


def port_forward(arch, dtype, port_impl, **kw):
    _, cfg = cfgs(arch, dtype, attn_impl=port_impl, **kw)
    params = port_params(arch, dtype, **kw)
    b = batch_np(cfg, B, S_FWD)
    h = forward(params, as_torch(b), cfg)
    assert h.dtype == getattr(torch, dtype)
    return logits_from_h(params, h, cfg)


@functools.lru_cache(maxsize=None)
def ref_generate(arch, dtype, **kw):
    """The reference's prefill of S tokens (cache and logits as numpy) and
    its logits of EXTRA decode steps."""
    rcfg, _ = cfgs(arch, dtype, **kw)
    params = ref_params(arch, dtype, **kw)
    b = batch_np(rcfg, B, MAX_SEQ, seed=2)
    cache, lg = ref_models.prefill(params, as_jnp(b, slice(0, S)), rcfg,
                                   max_seq=MAX_SEQ)
    cache_np = jax.tree.map(np.asarray, cache)
    steps = []
    tokens = jnp.asarray(b["tokens"])
    for t in range(EXTRA):
        out, cache = ref_models.decode_step(
            params, tokens[:, S + t:S + t + 1], cache, rcfg)
        steps.append(np.asarray(out))
    return cache_np, np.asarray(lg), steps


def port_decode_on_ref_cache(arch, dtype, **kw):
    """The port's EXTRA decode steps from the reference's prefill cache:
    (its logits, the reference's)."""
    cache_np, _, want = ref_generate(arch, dtype, **kw)
    _, cfg = cfgs(arch, dtype, **kw)
    params = port_params(arch, dtype, **kw)
    tokens = torch.as_tensor(batch_np(cfg, B, MAX_SEQ, seed=2)["tokens"])
    cache = convert.cache_from_numpy(cache_np, cfg, device="cpu")
    assert cache["index"] == S
    got = []
    for t in range(EXTRA):
        lg, cache = decode_step(params, tokens[:, S + t:S + t + 1], cache,
                                cfg)
        got.append(lg)
    assert cache["index"] == MAX_SEQ
    return got, want


def own_generation_errors(arch, dtype, **kw):
    """max |logit - forward's logit| of the port's own prefill and each
    decode step against its own forward of the whole sequence (teacher
    forcing), fresh parameters."""
    from repro_torch.models import init_params
    _, cfg = cfgs(arch, dtype, **kw)
    params = init_params(cfg, 4, device="cpu")
    b = batch_np(cfg, B, MAX_SEQ, seed=3)
    full = logits_from_h(params, forward(params, as_torch(b), cfg), cfg)
    cache, lg = prefill(params, as_torch(b, slice(0, S)), cfg,
                        max_seq=MAX_SEQ)
    errs = [(lg[:, 0] - full[:, S - 1]).abs().max().item()]
    tokens = torch.as_tensor(b["tokens"])
    for t in range(EXTRA):
        lg, cache = decode_step(params, tokens[:, S + t:S + t + 1], cache,
                                cfg)
        errs.append((lg[:, 0] - full[:, S + t]).abs().max().item())
    return errs


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def logit_errors(got, want, V):
    """(max, mean |got - want|, top-1 agreement) over the vocabulary;
    the logits must be finite."""
    got, want = to_np(got)[..., :V], to_np(want)[..., :V]
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    return (float(err.max()), float(err.mean()),
            float((got.argmax(-1) == want.argmax(-1)).mean()))


def assert_logits_close(got, want, dtype, V):
    mx, mean, top1 = logit_errors(got, want, V)
    if dtype == "float32":
        assert mx <= F32_ATOL, mx
    else:
        assert mx <= BF16_ATOL and mean <= BF16_MEAN and top1 >= BF16_TOP1, \
            (mx, mean, top1)


def leaves(tree, path=""):
    """(path, leaf) pairs of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k],
                                                        f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in leaves(v, f"{path}/{i}")]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# the checks each family's file parametrizes
# ---------------------------------------------------------------------------
def assert_same_config(ref_cfg, cfg):
    """Every field, property, count and layer kind equal."""
    assert type(cfg).__module__.startswith("repro_torch")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    for prop in ("padded_vocab", "d_inner", "cycles_and_tail", "is_encdec"):
        assert getattr(cfg, prop) == getattr(ref_cfg, prop), prop
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    n = cfg.num_layers + cfg.encoder_layers + 2
    assert [cfg.layer_kind(i) for i in range(n)] == \
        [ref_cfg.layer_kind(i) for i in range(n)]


def check_config(arch, name):
    rmod = __import__(f"repro.configs.{arch}", fromlist=["x"])
    pmod = __import__(f"repro_torch.configs.{arch}", fromlist=["x"])
    assert_same_config(getattr(rmod, name), getattr(pmod, name))
    getter = configs.get_config if name == "CONFIG" \
        else configs.get_smoke_config
    assert getter(arch.replace("_", "-")) == getattr(pmod, name)


def check_forward(arch, ref_impl, port_impl, dtype, **kw):
    """The port's forward logits against the reference's; its flash path
    runs the kernel's plain version here (no launch counted)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    want = ref_forward(arch, dtype, ref_impl, **kw)
    fa_ops.reset_launches()
    got = port_forward(arch, dtype, port_impl, **kw)
    assert fa_ops.flash_attention_fwd.launches == 0
    assert got.dtype == torch.float32 and got.shape == want.shape
    _, cfg = cfgs(arch, dtype, **kw)
    V = cfg.vocab_size
    np.testing.assert_array_equal(got.numpy()[..., V:], want[..., V:])
    assert_logits_close(got, want, dtype, V)


def check_prefill(arch, **kw):
    """float32 prefill: last-position logits and every cache leaf (float8
    rings bit for bit: both packages round the same float32 K/V)."""
    cache_np, want_lg, _ = ref_generate(arch, "float32", **kw)
    _, cfg = cfgs(arch, "float32", **kw)
    params = port_params(arch, "float32", **kw)
    b = batch_np(cfg, B, MAX_SEQ, seed=2)
    cache, lg = prefill(params, as_torch(b, slice(0, S)), cfg,
                        max_seq=MAX_SEQ)
    assert lg.shape == want_lg.shape == (B, 1, cfg.padded_vocab)
    assert_logits_close(lg, want_lg, "float32", cfg.vocab_size)
    assert cache["index"] == S == int(cache_np["index"])
    want = {p: x for p, x in leaves(cache_np) if p != "/index"}
    got = {p: x for p, x in leaves(cache) if p != "/index"}
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        g = got[p]
        assert tuple(g.shape) == w.shape, p
        assert str(g.dtype).split(".")[-1] == str(w.dtype), p
        if g.dtype == torch.float8_e4m3fn:
            np.testing.assert_array_equal(g.view(torch.uint8).numpy(),
                                          w.view(np.uint8), err_msg=p)
        else:
            np.testing.assert_allclose(to_np(g), w.astype(np.float32),
                                       rtol=0, atol=F32_ATOL, err_msg=p)
    return cache


def check_decode_on_ref_cache(arch, dtype, **kw):
    got, want = port_decode_on_ref_cache(arch, dtype, **kw)
    _, cfg = cfgs(arch, dtype, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, 1, cfg.padded_vocab)
        assert_logits_close(g, w, dtype, cfg.vocab_size)


def check_init_layout(arch):
    """`init_params` and `init_cache` of the port in the reference's
    layout (names, shapes, dtypes), parameters float32, the cache zero."""
    from repro_torch.models import init_cache, init_params
    rcfg, cfg = cfgs(arch, "bfloat16")
    params = init_params(cfg, 5, device="cpu")
    want = {p: x.shape for p, x in leaves(ref_models.param_shapes(rcfg))}
    assert {p: tuple(x.shape) for p, x in leaves(params)} == want
    assert all(t.dtype == torch.float32 for _p, t in leaves(params))
    rc = ref_models.init_cache(rcfg, B, MAX_SEQ)
    pc = init_cache(cfg, B, MAX_SEQ, device="cpu")
    assert pc["index"] == 0
    w = {p: x for p, x in leaves(rc) if not p.startswith("/index")}
    g = {p: x for p, x in leaves(pc) if not p.startswith("/index")}
    assert sorted(g) == sorted(w)
    for p in w:
        assert tuple(g[p].shape) == w[p].shape, p
        assert str(g[p].dtype).split(".")[-1] == str(w[p].dtype), p
        assert not g[p].float().any()


# ---------------------------------------------------------------------------
# the loss and its gradient (`test_torch_loss*.py`)
# ---------------------------------------------------------------------------
LOSS_RTOL = 1e-5             # float32 loss, relative
GRAD_TOL = 1e-4              # float32 gradient leaf, of its largest |g|


def ref_loss_and_grad(arch, dtype, params_dtype="float32", **kw):
    """The reference's `loss_fn` and its gradient (numpy leaves by path)
    on the 2 x 24 inputs, from the float32 parameters of ``arch``."""
    rcfg, _ = cfgs(arch, dtype, **kw)
    params = ref_params(arch, params_dtype)
    b = batch_np(rcfg, B, S_FWD)
    # jitted: one compile is several times faster than eager dispatch
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: ref_models.loss_fn(p, as_jnp(b), rcfg)))(params)
    return float(loss), dict(leaves(jax.tree.map(np.asarray, grads)))


def port_loss_and_grad(arch, dtype, params_dtype="float32", **kw):
    """The port's `loss_fn` and its gradient (`launch.steps.value_and_grad`)
    on the same inputs and carried-over parameters."""
    from repro_torch.launch.steps import value_and_grad
    _, cfg = cfgs(arch, dtype, **kw)
    params = port_params(arch, params_dtype)
    loss, grads = value_and_grad(params, as_torch(batch_np(cfg, B, S_FWD)),
                                 cfg)
    return float(loss), {p: g.numpy() for p, g in leaves(grads)}


def assert_grads_close(got, want, tol=GRAD_TOL):
    """Each leaf within ``tol`` of its largest |g|."""
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[p] - w).max())
        assert err <= tol * scale, (p, err, scale)


def grad_distance(a, b):
    """||a - b|| / ||b|| over all leaves (dicts by path)."""
    num = sum(float(np.sum((a[p] - b[p]) ** 2)) for p in b)
    den = sum(float(np.sum(b[p] ** 2)) for p in b)
    return (num / max(den, 1e-300)) ** 0.5


def check_loss_float32(arch, **kw):
    want_l, want_g = ref_loss_and_grad(arch, "float32", **kw)
    got_l, got_g = port_loss_and_grad(arch, "float32", **kw)
    assert np.isfinite(got_l)
    assert abs(got_l - want_l) <= LOSS_RTOL * abs(want_l), (got_l, want_l)
    assert_grads_close(got_g, want_g)


BF16_FACTOR = 3.0            # see check_loss_bfloat16


def check_loss_bfloat16(arch):
    """bfloat16 compute from the same float32 parameters: the port's
    distance from the float32 loss and gradient at most BF16_FACTOR times
    the reference's own bfloat16 distance from it (the two packages round
    bfloat16 products in other places; XLA keeps excess precision between
    fused ops).  The float32 point is the port's, which
    `check_loss_float32` holds to the reference's within 1e-4 of each
    leaf's largest |g| (measured 5e-6, against bfloat16 distances of
    1e-2 and more): it saves a compile of the reference."""
    l32, g32 = port_loss_and_grad(arch, "float32")
    l16, g16 = ref_loss_and_grad(arch, "bfloat16")
    pl, pg = port_loss_and_grad(arch, "bfloat16")
    assert np.isfinite(pl)
    ref_l, port_l = abs(l16 - l32), abs(pl - l32)
    assert port_l <= BF16_FACTOR * ref_l, (port_l, ref_l)
    ref_g, port_g = grad_distance(g16, g32), grad_distance(pg, g32)
    assert port_g <= BF16_FACTOR * ref_g, (port_g, ref_g)
    return (ref_l, port_l), (ref_g, port_g)
