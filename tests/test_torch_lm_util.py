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
