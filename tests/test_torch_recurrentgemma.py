"""recurrentgemma-9b in the port (`repro_torch.configs.recurrentgemma_9b`,
the RG-LRU mixer of `repro_torch.models`) against the reference's, on the
CPU, where the recurrence kernel's plain version runs.

Model: the SMOKE configuration (8 layers = 2 cycles of (RG-LRU, RG-LRU,
local attention) + 2 RG-LRU tail layers; d 64, lru_width 64, 4 heads on 1
KV head, window 8), the reference's `init_params` pytree carried across
with `convert.model_params_from_numpy`.  Prompts of 12 tokens and
``max_seq`` 16: the 8-slot local rings have wrapped at prefill and keep
wrapping in decode.

* The configuration field for field, `param_count` included.
* `forward` (both ``impl``s) against the reference's forward.
* `prefill`: last-position logits and every cache leaf (RG-LRU states,
  conv windows, K/V rings) against the reference's; `init_cache` in the
  reference's layout.
* `decode_step`: 4 steps on the reference's prefill cache, carried across
  with `convert.cache_from_numpy`, against the reference's `decode_step`.
* The port's own prefill + decode against its own forward (teacher
  forcing), at the reference's bar of 1e-3.

Tolerances.  float32 (with a float32 KV cache): logits, hidden states and
cache leaves to 5e-5 absolute, as `tests/test_torch_generate.py` (measured
below 1e-5).  bfloat16: both frameworks round at other places, and over
this model's 8 layers the reference's own bfloat16 logits differ from its
float32 logits by 0.39 at most and 0.035 on average (scale ~4), more than
the bounds `tests/test_torch_generate.py` puts between the two packages'
bfloat16 runs.  So each bfloat16 result of the port is held to the
reference's own bfloat16 accuracy: its max and mean distance from the
reference's float32 logits at most 1.25 times the reference's bfloat16
distance, and top-1 equal to the float32 logits' on 85% of positions
(measured: forward 0.27 / 0.029 against 0.39 / 0.035, top-1 87.5%;
decode 0.33 / 0.044 against 0.39 / 0.047, top-1 100%).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.configs.recurrentgemma_9b as ref_rg
import repro.models as ref_models
from repro_torch import configs, convert
from repro_torch.configs import recurrentgemma_9b
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, layers, logits_from_h, prefill)

ARCH = "recurrentgemma_9b"
S, EXTRA, B = 12, 4, 2
MAX_SEQ = S + EXTRA
F32_ATOL = 5e-5
BF16_OWN, BF16_TOP1 = 1.25, 0.85


def _cfgs(dtype, **kw):
    """(reference config, port config) of the SMOKE model in ``dtype``;
    float32 keeps the KV cache in float32 too."""
    extra = dict(dtype=dtype, **kw)
    if dtype == "float32":
        extra["kv_cache_dtype"] = "float32"
    return (dataclasses.replace(ref_configs.get_smoke_config(ARCH), **extra),
            dataclasses.replace(configs.get_smoke_config(ARCH), **extra))


def _tokens(cfg):
    return np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, MAX_SEQ)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_params():
    rcfg, _ = _cfgs("float32")
    return ref_models.init_params(rcfg, jax.random.key(3))


def _port_params():
    return convert.model_params_from_numpy(
        jax.tree.map(np.asarray, _ref_params()), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _assert_f32_close(got, want, V):
    got, want = _np(got)[..., :V], _np(want)[..., :V]
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= F32_ATOL, np.abs(got - want).max()


def _assert_bf16_as_accurate(got, ref_bf16, ref_f32, V):
    """The port's bfloat16 logits no further from the reference's float32
    ones than the reference's own bfloat16 logits are (x 1.25), top-1 on
    85% of positions."""
    got, rb, rf = (_np(x)[..., :V] for x in (got, ref_bf16, ref_f32))
    assert np.isfinite(got).all()
    err, own = np.abs(got - rf), np.abs(rb - rf)
    top1 = (got.argmax(-1) == rf.argmax(-1)).mean()
    assert err.max() <= BF16_OWN * own.max() \
        and err.mean() <= BF16_OWN * own.mean() and top1 >= BF16_TOP1, \
        (err.max(), own.max(), err.mean(), own.mean(), top1)


# ---------------------------------------------------------------------------
# configuration and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_recurrentgemma_config_matches_reference(name):
    want = getattr(ref_rg, name)
    got = getattr(recurrentgemma_9b, name)
    assert type(got).__module__.startswith("repro_torch")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("padded_vocab", "d_inner", "cycles_and_tail", "is_encdec"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.param_count() == want.param_count()
    assert [got.layer_kind(i) for i in range(got.num_layers)] == \
        [want.layer_kind(i) for i in range(want.num_layers)]
    assert configs.get_config("recurrentgemma-9b") == recurrentgemma_9b.CONFIG
    assert configs.get_smoke_config(ARCH) == recurrentgemma_9b.SMOKE


def test_init_params_in_reference_layout():
    """RG-LRU and attention blocks in the reference's pytree (names,
    stacked shapes), float32, the 1/sqrt(fan_in) scale."""
    cfg = configs.get_smoke_config(ARCH)
    params = init_params(cfg, 5, device="cpu")
    want = {p: x.shape for p, x in _leaves(ref_models.param_shapes(
        ref_configs.get_smoke_config(ARCH)))}
    assert {p: tuple(x.shape) for p, x in _leaves(params)} == want
    assert all(t.dtype == torch.float32 for _p, t in _leaves(params))
    w = params["blocks"][0]["wx"]
    fan_in = int(np.prod(w.shape[:-1]))
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_forward(dtype):
    rcfg, _ = _cfgs(dtype)
    params = _ref_params()
    h = ref_models.forward(params, {"tokens": jnp.asarray(_tokens(rcfg))},
                           rcfg)
    return np.asarray(ref_models.logits_from_h(params, h, rcfg)), \
        np.asarray(h.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_forward_matches_reference(impl, dtype):
    want, want_h = _ref_forward(dtype)
    _, cfg = _cfgs(dtype)
    params = _port_params()
    tokens = torch.as_tensor(_tokens(cfg))
    rg_ops.reset_launches()
    fa_ops.reset_launches()
    h = forward(params, {"tokens": tokens}, cfg, impl=impl)
    got = logits_from_h(params, h, cfg)
    assert rg_ops.rglru_scan_fwd.launches == 0      # plain versions on CPU
    assert fa_ops.flash_attention_fwd.launches == 0
    assert h.dtype == getattr(torch, dtype) and got.shape == want.shape
    V = cfg.vocab_size
    if dtype == "float32":
        _assert_f32_close(got, want, V)
        np.testing.assert_allclose(h.numpy(), want_h, rtol=0, atol=F32_ATOL)
    else:
        _assert_bf16_as_accurate(got, want, _ref_forward("float32")[0], V)


def test_forward_routes_the_recurrence_by_impl(monkeypatch):
    """``impl="pallas"`` (the default) reaches the kernel entry in each of
    the 6 RG-LRU layers (2 cycles x 2 + 2 tail), ``"jnp"`` never; the 2
    local layers go to the flash entry under ``attn_impl="auto"``."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              attn_impl="auto")
    params = init_params(cfg, 0, device="cpu")
    calls = []
    for name in ("rglru_scan", "flash_attention"):
        real = getattr(layers, name)
        monkeypatch.setattr(
            layers, name,
            lambda *a, _n=name, _r=real, **k: (calls.append(_n),
                                               _r(*a, **k))[1])
    batch = {"tokens": torch.zeros((1, 10), dtype=torch.int64)}
    for kw, n in (({}, 6), ({"impl": "pallas"}, 6), ({"impl": "jnp"}, 0)):
        calls.clear()
        forward(params, batch, cfg, **kw)
        assert calls.count("rglru_scan") == n, kw
        assert calls.count("flash_attention") == 2, kw


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_generate(dtype):
    """The reference's prefill of the first S tokens (cache and logits as
    numpy) and its logits of EXTRA decode steps."""
    rcfg, _ = _cfgs(dtype)
    params = _ref_params()
    tokens = jnp.asarray(_tokens(rcfg))
    cache, lg = ref_models.prefill(params, {"tokens": tokens[:, :S]}, rcfg,
                                   max_seq=MAX_SEQ)
    cache_np = jax.tree.map(np.asarray, cache)
    steps = []
    for t in range(EXTRA):
        out, cache = ref_models.decode_step(
            params, tokens[:, S + t:S + t + 1], cache, rcfg)
        steps.append(np.asarray(out))
    return cache_np, np.asarray(lg), steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_reference_layout(dtype):
    rcfg, cfg = _cfgs(dtype)
    want = ref_models.init_cache(rcfg, B, MAX_SEQ)
    got = init_cache(cfg, B, MAX_SEQ, device="cpu")
    assert got["index"] == 0
    w = {p: x for p, x in _leaves(want) if not p.startswith("/index")}
    g = {p: x for p, x in _leaves(got) if not p.startswith("/index")}
    assert sorted(g) == sorted(w)
    for p in w:
        assert tuple(g[p].shape) == w[p].shape, p
        assert str(g[p].dtype).split(".")[-1] == str(w[p].dtype), p
        assert not g[p].any()


def test_prefill_matches_reference():
    cache_np, want_lg, _ = _ref_generate("float32")
    _, cfg = _cfgs("float32")
    params = _port_params()
    tokens = torch.as_tensor(_tokens(cfg))
    cache, lg = prefill(params, {"tokens": tokens[:, :S]}, cfg,
                        max_seq=MAX_SEQ)
    assert lg.shape == want_lg.shape == (B, 1, cfg.padded_vocab)
    _assert_f32_close(lg, want_lg, cfg.vocab_size)
    assert cache["index"] == S == int(cache_np["index"])
    want = {p: x for p, x in _leaves(cache_np) if p != "/index"}
    got = {p: x for p, x in _leaves(cache) if p != "/index"}
    assert sorted(got) == sorted(want)
    assert any(p.endswith("/state") for p in got)
    for p, w in want.items():
        assert tuple(got[p].shape) == w.shape, p
        np.testing.assert_allclose(_np(got[p]), w.astype(np.float32),
                                   rtol=0, atol=F32_ATOL, err_msg=p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_on_reference_cache_matches_reference(dtype):
    """The reference's prefill cache carried across; the port decodes 4
    tokens from it in place, its RG-LRU states and conv windows included."""
    cache_np, _, want_steps = _ref_generate(dtype)
    _, cfg = _cfgs(dtype)
    params = _port_params()
    tokens = torch.as_tensor(_tokens(cfg))
    cache = convert.cache_from_numpy(cache_np, cfg, device="cpu")
    state = cache["tail"][0]["state"]
    before = state.clone()
    rg_ops.reset_launches()
    got = []
    for t in range(EXTRA):
        lg, cache = decode_step(params, tokens[:, S + t:S + t + 1], cache,
                                cfg)
        assert lg.shape == want_steps[t].shape == (B, 1, cfg.padded_vocab)
        got.append(lg)
    assert cache["index"] == S + EXTRA
    assert cache["tail"][0]["state"] is state and not torch.equal(state,
                                                                  before)
    assert rg_ops.rglru_scan_fwd.launches == 0
    V = cfg.vocab_size
    if dtype == "float32":
        for g, w in zip(got, want_steps):
            _assert_f32_close(g, w, V)
    else:
        _assert_bf16_as_accurate(torch.cat(got, dim=1),
                                 np.concatenate(want_steps, axis=1),
                                 np.concatenate(_ref_generate("float32")[2],
                                                axis=1), V)


# ---------------------------------------------------------------------------
# the port against itself: prefill + decode == teacher-forced forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_own_prefill_decode_matches_own_forward(dtype):
    """The reference's bar: every prefill and decode logit within 1e-3 of
    the forward's at the same position."""
    _, cfg = _cfgs(dtype)
    params = init_params(cfg, 4, device="cpu")
    tokens = torch.as_tensor(_tokens(cfg))
    full = logits_from_h(params, forward(params, {"tokens": tokens}, cfg),
                         cfg)
    cache, lg = prefill(params, {"tokens": tokens[:, :S]}, cfg,
                        max_seq=MAX_SEQ)
    errs = [(lg[:, 0] - full[:, S - 1]).abs().max().item()]
    for t in range(EXTRA):
        lg, cache = decode_step(params, tokens[:, S + t:S + t + 1], cache,
                                cfg)
        errs.append((lg[:, 0] - full[:, S + t]).abs().max().item())
    assert max(errs) <= 1e-3, errs
    assert cache["index"] == MAX_SEQ
