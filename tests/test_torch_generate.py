"""The port's generation path (`repro_torch.models` `init_cache`,
`prefill`, `decode_step`) and the mamba2 forward against the reference's,
on the CPU, where the kernels' plain versions run.

Models: gemma3-1b's SMOKE (14 layers of the 5:1 local/global pattern,
local window 8, GQA 4:1) and mamba2-130m's SMOKE (2 SSD layers, chunk 8),
the reference's `init_params` pytree carried across with
`convert.model_params_from_numpy`.  Prompts of 12 tokens and
``max_seq`` 16: gemma3's local rings (8 slots) have wrapped at prefill,
and 12 is not a multiple of mamba2's chunk.

* mamba2's configuration field for field.
* `forward` of mamba2 with both ``impl``s against the reference's, which
  runs its jnp path and its Pallas kernel in interpret mode.
* `prefill`: last-position logits and every cache leaf against the
  reference's; `init_cache` in the reference's layout.
* `decode_step`: 4 steps on the reference's prefill cache, carried across
  with `convert.cache_from_numpy`, against the reference's `decode_step`.
* The port's own prefill + decode against its own forward on the whole
  sequence (teacher forcing), at the reference's own bar of 1e-3
  (`tests/test_archs.py::test_prefill_decode_matches_forward`).

float32 runs keep the KV cache in float32 (``kv_cache_dtype``), so a
cached K/V row is the forward's own.  Tolerances: float32 logits, hidden
states and cache leaves to 5e-5 absolute (float32 products summed in
other orders, as `tests/test_torch_models.py` bounds the forward;
measured below 1e-5).  bfloat16 logits (scale ~1) within the bounds
`tests/test_torch_models.py` states for the bfloat16 forward (0.25 max,
0.02 mean, top-1 on 85% of positions): the two frameworks round bfloat16
at different places.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.configs.mamba2_130m as ref_mamba2
import repro.models as ref_models
from repro_torch import configs, convert
from repro_torch.configs import mamba2_130m
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, layers, logits_from_h, prefill)

ARCHS = ("gemma3_1b", "mamba2_130m")
S, EXTRA, B = 12, 4, 2
MAX_SEQ = S + EXTRA
F32_ATOL = 5e-5
BF16_ATOL, BF16_MEAN, BF16_TOP1 = 0.25, 0.02, 0.85


def _cfgs(arch, dtype, **kw):
    """(reference config, port config) of the SMOKE model in ``dtype``;
    float32 keeps the KV cache in float32 too."""
    extra = dict(dtype=dtype, **kw)
    if dtype == "float32":
        extra["kv_cache_dtype"] = "float32"
    return (dataclasses.replace(ref_configs.get_smoke_config(arch), **extra),
            dataclasses.replace(configs.get_smoke_config(arch), **extra))


def _tokens(cfg):
    return np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, MAX_SEQ)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, dtype):
    rcfg, _ = _cfgs(arch, dtype)
    return ref_models.init_params(rcfg, jax.random.key(3))


def _port_params(arch, dtype):
    return convert.model_params_from_numpy(
        jax.tree.map(np.asarray, _ref_params(arch, dtype)), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_logits_close(got, want, dtype, V):
    got, want = _np(got)[..., :V], _np(want)[..., :V]
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= F32_ATOL, err.max()
    else:
        top1 = (got.argmax(-1) == want.argmax(-1)).mean()
        assert err.max() <= BF16_ATOL and err.mean() <= BF16_MEAN \
            and top1 >= BF16_TOP1, (err.max(), err.mean(), top1)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_mamba2_config_matches_reference(name):
    want = getattr(ref_mamba2, name)
    got = getattr(mamba2_130m, name)
    assert type(got).__module__.startswith("repro_torch")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("padded_vocab", "d_inner", "cycles_and_tail", "is_encdec"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.param_count() == want.param_count()
    assert configs.get_config("mamba2-130m") == mamba2_130m.CONFIG
    assert configs.get_smoke_config("mamba2_130m") == mamba2_130m.SMOKE


# ---------------------------------------------------------------------------
# mamba2 forward
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_forward(dtype, impl):
    rcfg, _ = _cfgs("mamba2_130m", dtype)
    params = _ref_params("mamba2_130m", dtype)
    tokens = _tokens(rcfg)
    h = ref_models.forward(params, {"tokens": jnp.asarray(tokens)}, rcfg,
                           impl=impl)
    return np.asarray(ref_models.logits_from_h(params, h, rcfg)), \
        np.asarray(h.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref_impl,port_impl", [
    ("jnp", "jnp"), ("jnp", "pallas"), ("pallas", "pallas")])
def test_mamba2_forward_matches_reference(ref_impl, port_impl, dtype):
    want, want_h = _ref_forward(dtype, ref_impl)
    _, cfg = _cfgs("mamba2_130m", dtype)
    params = _port_params("mamba2_130m", dtype)
    tokens = torch.as_tensor(_tokens(cfg))
    ssd_ops.reset_launches()
    h = forward(params, {"tokens": tokens}, cfg, impl=port_impl)
    got = logits_from_h(params, h, cfg)
    assert ssd_ops.ssd_scan_fwd.launches == 0       # plain versions on CPU
    assert h.dtype == getattr(torch, dtype) and got.shape == want.shape
    V = cfg.vocab_size
    np.testing.assert_array_equal(got.numpy()[..., V:], want[..., V:])
    _assert_logits_close(got, want, dtype, V)
    if dtype == "float32":
        np.testing.assert_allclose(h.numpy(), want_h, rtol=0, atol=F32_ATOL)


def test_forward_routes_the_ssd_scan_by_impl(monkeypatch):
    """``impl="pallas"`` (the default) reaches the kernel entry in every
    SSD layer, ``"jnp"`` never does; another name raises."""
    cfg = configs.get_smoke_config("mamba2_130m")
    params = init_params(cfg, 0, device="cpu")
    calls = []
    real = layers.ssd_scan

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(layers, "ssd_scan", spy)
    batch = {"tokens": torch.zeros((1, 10), dtype=torch.int64)}
    for kw, n in (({}, 2), ({"impl": "pallas"}, 2), ({"impl": "jnp"}, 0)):
        calls.clear()
        forward(params, batch, cfg, **kw)
        assert len(calls) == n, kw
    with pytest.raises(ValueError, match="impl"):
        forward(params, batch, cfg, impl="chunked")


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_generate(arch, dtype):
    """The reference's prefill of the first S tokens (as numpy: cache and
    logits) and its logits of EXTRA decode steps."""
    rcfg, _ = _cfgs(arch, dtype)
    params = _ref_params(arch, dtype)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference_layout(arch):
    rcfg, cfg = _cfgs(arch, "bfloat16")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cache_np, want_lg, _ = _ref_generate(arch, "float32")
    _, cfg = _cfgs(arch, "float32")
    params = _port_params(arch, "float32")
    tokens = torch.as_tensor(_tokens(cfg))
    cache, lg = prefill(params, {"tokens": tokens[:, :S]}, cfg,
                        max_seq=MAX_SEQ)
    assert lg.shape == want_lg.shape == (B, 1, cfg.padded_vocab)
    _assert_logits_close(lg, want_lg, "float32", cfg.vocab_size)
    assert cache["index"] == S == int(cache_np["index"])
    want = {p: x for p, x in _leaves(cache_np) if p != "/index"}
    got = {p: x for p, x in _leaves(cache) if p != "/index"}
    assert sorted(got) == sorted(want)
    for p, w in want.items():
        assert tuple(got[p].shape) == w.shape, p
        np.testing.assert_allclose(_np(got[p]), w.astype(np.float32),
                                   rtol=0, atol=F32_ATOL, err_msg=p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_on_reference_cache_matches_reference(arch, dtype):
    """The reference's prefill cache carried across; the port decodes 4
    tokens from it in place."""
    cache_np, _, want_steps = _ref_generate(arch, dtype)
    _, cfg = _cfgs(arch, dtype)
    params = _port_params(arch, dtype)
    tokens = torch.as_tensor(_tokens(cfg))
    cache = convert.cache_from_numpy(cache_np, cfg, device="cpu")
    assert cache["index"] == S
    da_ops.reset_launches()
    for t in range(EXTRA):
        lg, cache = decode_step(params, tokens[:, S + t:S + t + 1], cache,
                                cfg)
        assert lg.shape == want_steps[t].shape == (B, 1, cfg.padded_vocab)
        _assert_logits_close(lg, want_steps[t], dtype, cfg.vocab_size)
    assert cache["index"] == S + EXTRA
    assert da_ops.decode_attention_fwd.launches == 0


# ---------------------------------------------------------------------------
# the port against itself: prefill + decode == teacher-forced forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_own_prefill_decode_matches_own_forward(arch, dtype):
    """The reference's bar: every prefill and decode logit within 1e-3 of
    the forward's at the same position."""
    _, cfg = _cfgs(arch, dtype)
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


@pytest.mark.parametrize("impl,n", [("auto", 12), ("pallas", 12),
                                    ("dense", 0)])
def test_decode_routes_attention_by_attn_impl(monkeypatch, impl, n):
    """gemma3's 12 local and 2 global layers: the flash-decode entry on
    every attention layer unless ``attn_impl="dense"``; local layers get
    their window, global ones none."""
    _, cfg = _cfgs("gemma3_1b", "float32", attn_impl=impl)
    params = init_params(cfg, 1, device="cpu")
    calls = []
    real = layers.decode_attention

    def spy(*a, **k):
        calls.append(k["window"])
        return real(*a, **k)

    monkeypatch.setattr(layers, "decode_attention", spy)
    tokens = torch.zeros((1, 6), dtype=torch.int64)
    cache, _ = prefill(params, {"tokens": tokens}, cfg, max_seq=8)
    logits, cache = decode_step(params, tokens[:, :1], cache, cfg)
    assert len(calls) == n + (2 if n else 0)
    if n:
        assert calls.count(cfg.local_window) == 12 and calls.count(0) == 2
    assert torch.isfinite(logits[..., :cfg.vocab_size]).all()


def test_decode_writes_the_ring_slot_in_place():
    """The new K/V row lands in slot index % W of the cache passed in (a
    local ring of 8 slots at index 12: slot 4), and nothing else moves."""
    _, cfg = _cfgs("gemma3_1b", "float32")
    params = init_params(cfg, 2, device="cpu")
    tokens = torch.as_tensor(_tokens(cfg))
    cache, _ = prefill(params, {"tokens": tokens[:, :S]}, cfg,
                       max_seq=MAX_SEQ)
    ring = cache["blocks"][0]["k"]                  # local, (cycles, B, 8,
    before = ring.clone()                           #  KH, Hd)
    _, new = decode_step(params, tokens[:, S:S + 1], cache, cfg)
    assert new["blocks"][0]["k"] is ring
    changed = (ring != before).flatten(3).any(-1)   # (cycles, B, 8)
    assert changed[:, :, S % 8].all()
    changed[:, :, S % 8] = False
    assert not changed.any()


def test_mamba2_init_params_in_reference_layout():
    """SSD blocks in the reference's pytree (names, stacked shapes),
    float32, the 1/sqrt(fan_in) scale on the stacked in-projection."""
    cfg = configs.get_smoke_config("mamba2_130m")
    params = init_params(cfg, 5, device="cpu")
    want = {p: x.shape for p, x in _leaves(ref_models.param_shapes(
        ref_configs.get_smoke_config("mamba2_130m")))}
    got = {p: tuple(x.shape) for p, x in _leaves(params)}
    assert got == want
    assert all(t.dtype == torch.float32 for _p, t in _leaves(params))
    w = params["blocks"][0]["in_proj"]
    fan_in = int(np.prod(w.shape[:-1]))
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
