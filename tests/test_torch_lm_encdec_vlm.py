"""The encoder-decoder and the VLM of the port — whisper-base and
internvl2-76b — against the reference's, on the CPU, at their SMOKE sizes.

whisper's SMOKE: 2 encoder layers over 16 frame embeddings (unmasked
self-attention, no RoPE, GELU), 2 decoder layers of causal
self-attention + cross-attention to the encoder's output, 4 q heads on 4
KV.  internvl2's SMOKE: 2 dense layers, 4 patch embeddings replacing the
first 4 token positions, a float8_e4m3fn KV cache (kept in the float32
runs too: both packages round the same float32 K/V to the same bits).

* Configurations field for field; forward (reference dense and Pallas in
  interpret mode — its flash kernel takes whisper's cross-attention, Sq
  24 against Sk 16 — port dense and flash); prefill (logits, every cache
  leaf: whisper's ``enc_out``, internvl2's float8 rings bit for bit);
  `decode_step` on the reference's cache (whisper: cross K/V recomputed
  from the carried ``enc_out`` every step); own prefill + decode against
  own forward at the reference's bars (1e-3; 0.6 with the float8 cache,
  `tests/test_archs.py`); layouts.
* whisper's attention calls: per forward 2 encoder calls unmasked, 2
  causal self-attention and 2 unmasked cross-attention calls of the flash
  entry; per decode step 2 flash-decode calls and 2 flash calls of one
  query.
* `convert.cache_from_numpy` refuses a cache whose ``enc_out`` does not
  fit the model.

Tolerances as `tests/test_torch_lm_dense.py`.
"""
import numpy as np
import pytest
import torch

import test_torch_lm_util as U
from repro_torch import convert
from repro_torch.models import (decode_step, forward, init_params, layers,
                                prefill)

ARCHS = ("whisper_base", "internvl2_76b")
DTYPES = ("float32", "bfloat16")


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
    cache = U.check_prefill(arch)
    _, cfg = U.cfgs(arch, "float32")
    if cfg.is_encdec:
        assert cache["enc_out"].shape == (U.B, cfg.encoder_seq, cfg.d_model)
    else:
        assert all(c[n].dtype == torch.float8_e4m3fn
                   for c in cache["blocks"] for n in ("k", "v"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_on_reference_cache_matches_reference(arch, dtype):
    U.check_decode_on_ref_cache(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_own_prefill_decode_matches_own_forward(arch, dtype):
    _, cfg = U.cfgs(arch, dtype)
    errs = U.own_generation_errors(arch, dtype)
    bar = 0.6 if cfg.kv_cache_dtype == "float8_e4m3fn" else 1e-3
    assert max(errs) <= bar, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_cache_in_reference_layout(arch):
    U.check_init_layout(arch)


def test_whisper_routes_every_attention_through_flash(monkeypatch):
    """Forward: 2 unmasked encoder, 2 causal self and 2 unmasked cross
    calls of the flash entry (cross: Sq 12 against Sk 16).  A decode
    step: 2 flash-decode calls and 2 cross calls of one query."""
    _, cfg = U.cfgs("whisper_base", "float32", attn_impl="auto")
    params = init_params(cfg, 1, device="cpu")
    calls = []
    real_fa, real_da = layers.flash_attention, layers.decode_attention

    def fa(q, k, *a, **kw):
        calls.append(("flash", kw["mask_kind"], q.shape[1], k.shape[1]))
        return real_fa(q, k, *a, **kw)

    def da(*a, **kw):
        calls.append(("decode",))
        return real_da(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", fa)
    monkeypatch.setattr(layers, "decode_attention", da)
    b = U.as_torch(U.batch_np(cfg, 1, 12))
    forward(params, b, cfg)
    Se = cfg.encoder_seq
    assert sorted(calls) == sorted(
        [("flash", "none", Se, Se)] * 2 + [("flash", "causal", 12, 12)] * 2
        + [("flash", "none", 12, Se)] * 2)
    cache, _ = prefill(params, b, cfg, max_seq=16)
    calls.clear()
    decode_step(params, b["tokens"][:, :1], cache, cfg)
    assert sorted(calls) == sorted([("decode",)] * 2
                                   + [("flash", "none", 1, Se)] * 2)


def test_whisper_cross_attention_reads_the_carried_encoder_output():
    """A decode step attends to the cache's ``enc_out``: other frames in
    it give other logits, the same frames the same."""
    _, cfg = U.cfgs("whisper_base", "float32")
    params = init_params(cfg, 2, device="cpu")
    b = U.as_torch(U.batch_np(cfg, 2, 12))
    cache, _ = prefill(params, b, cfg, max_seq=16)
    other = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in cache.items()}
    other["blocks"] = tuple({n: t.clone() for n, t in d.items()}
                            for d in cache["blocks"])
    other["enc_out"] = cache["enc_out"] + 1.0
    tok = b["tokens"][:, :1]
    a, _ = decode_step(params, tok, cache, cfg)
    c, _ = decode_step(params, tok, other, cfg)
    assert not torch.allclose(a, c)


def test_patch_embeds_replace_the_first_positions():
    """internvl2: the first 4 positions' hidden states follow the patch
    embeddings, not the tokens there; the rest follow the tokens."""
    _, cfg = U.cfgs("internvl2_76b", "float32")
    params = init_params(cfg, 3, device="cpu")
    b = U.as_torch(U.batch_np(cfg, 1, 8))
    h = forward(params, b, cfg)
    tokens = b["tokens"].clone()
    tokens[:, :cfg.num_patches] = (tokens[:, :cfg.num_patches] + 1) % 256
    assert torch.equal(forward(params, dict(b, tokens=tokens), cfg), h)
    pe = b["patch_embeds"].clone()
    pe[:, 0] += 1.0
    assert not torch.equal(forward(params, dict(b, patch_embeds=pe), cfg), h)


def test_cache_from_numpy_checks_enc_out():
    _, whisper = U.cfgs("whisper_base", "float32")
    _, dense = U.cfgs("internlm2_20b", "float32")
    cache_np, _, _ = U.ref_generate("whisper_base", "float32")
    got = convert.cache_from_numpy(cache_np, whisper, device="cpu")
    np.testing.assert_array_equal(got["enc_out"].numpy(),
                                  cache_np["enc_out"])
    with pytest.raises(ValueError, match="enc_out"):
        convert.cache_from_numpy(
            {k: v for k, v in cache_np.items() if k != "enc_out"}, whisper)
    dense_np, _, _ = U.ref_generate("internlm2_20b", "float32")
    with pytest.raises(ValueError, match="enc_out"):
        convert.cache_from_numpy(dict(dense_np, enc_out=np.zeros(1)), dense,
                                 device="cpu")
