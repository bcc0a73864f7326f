"""The float8_e4m3fn KV cache of the port (internvl2's) against the
reference, on the CPU.

* `layers.cast_kv` equals ``jnp.asarray(x).astype(jnp.float8_e4m3fn)``
  byte for byte over all 65,536 bfloat16 bit patterns and over float32
  values at and next to every e4m3 value and rounding midpoint, past
  ±448 and at ±inf: round to nearest even in range, NaN (its sign kept)
  past 464, where `Tensor.to` saturates to ±448 (shown here too).
* The ring cache written through it: `attn_prefill_cache` and the decode
  step's in-place slot write hold `cast_kv`'s bytes.
* The flash-decode plain version on a float8 cache equals itself on the
  cache widened to q's type (the reference's wrapper casts the cache).
* `convert` carries float8 leaves by their bits.
"""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.models import init_params, layers

FP8 = torch.float8_e4m3fn


def _ref_bytes(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(
        np.uint8)


def _port_bytes(x: torch.Tensor) -> np.ndarray:
    y = layers.cast_kv(x, FP8)
    assert y.dtype == FP8 and y.shape == x.shape
    return y.view(torch.uint8).numpy()


def _assert_same_bytes(got, want):
    nan_g = np.isnan(got.view(ml_dtypes.float8_e4m3fn).astype(np.float32))
    nan_w = np.isnan(want.view(ml_dtypes.float8_e4m3fn).astype(np.float32))
    np.testing.assert_array_equal(nan_g, nan_w)     # NaN where NaN
    np.testing.assert_array_equal(got, want)        # and every byte


def test_cast_matches_reference_on_every_bfloat16_pattern():
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    want = _ref_bytes(bits.view(ml_dtypes.bfloat16))
    got = _port_bytes(torch.from_numpy(bits.view(np.int16)).view(
        torch.bfloat16))
    _assert_same_bytes(got, want)
    assert np.isnan(want.view(ml_dtypes.float8_e4m3fn).astype(
        np.float32)).sum() > 2 * 256        # past the range, not only NaNs


def _float32_probes():
    """Every finite e4m3 value, every midpoint between neighbours, the
    overflow edges 464 and 480, large values and infinities, both signs,
    each with its float32 neighbours."""
    f8 = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    vals = np.unique(f8.astype(np.float32)[np.isfinite(f8.astype(
        np.float32))])
    mids = (vals[1:] + vals[:-1]) / 2
    edges = np.array([448, 456, 464, 472, 480, 500, 1000, 3e38, np.inf],
                     np.float32)
    base = np.concatenate([vals, mids, edges])
    base = np.concatenate([base, -base])
    return np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))]
                          ).astype(np.float32)


def test_cast_matches_reference_around_every_midpoint_and_overflow():
    x = _float32_probes()
    _assert_same_bytes(_port_bytes(torch.from_numpy(x)), _ref_bytes(x))
    # the reference's NaN past the range, where torch's own cast saturates
    over = np.array([464.1, 500.0, 1000.0, -600.0, np.inf], np.float32)
    assert np.isnan(_ref_bytes(over).view(ml_dtypes.float8_e4m3fn).astype(
        np.float32)).all()
    assert torch.equal(torch.from_numpy(over).to(FP8).float().abs(),
                             torch.full((5,), 448.0))


@pytest.mark.parametrize("scale", [1.0, 100.0, 1e-3])
def test_cast_matches_reference_on_random_float32(scale):
    x = (np.random.default_rng(0).standard_normal(100_000) * scale
         ).astype(np.float32)
    _assert_same_bytes(_port_bytes(torch.from_numpy(x)), _ref_bytes(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cast_to_other_cache_types_is_a_plain_cast(dtype):
    x = torch.randn(64) * 1000
    assert torch.equal(layers.cast_kv(x, dtype), x.to(dtype))


def _fp8_cfg():
    return dataclasses.replace(configs.get_smoke_config("internvl2_76b"),
                               dtype="float32")


def test_prefill_ring_holds_the_cast_bytes():
    cfg = _fp8_cfg()
    g = torch.Generator().manual_seed(0)
    k = torch.randn(2, 12, cfg.num_kv_heads, cfg.head_dim, generator=g) * 300
    v = torch.randn(2, 12, cfg.num_kv_heads, cfg.head_dim, generator=g)
    cache = layers.attn_prefill_cache({}, (k, v), "full", cfg, 16)
    assert cache["k"].dtype == cache["v"].dtype == FP8
    kb = cache["k"].view(torch.uint8)
    assert torch.equal(kb[:, :12], layers.cast_kv(k, FP8).view(torch.uint8))
    assert not kb[:, 12:].any()                     # +0.0 bytes
    assert torch.isnan(cache["k"].float()).any()    # |k| past 464
    assert torch.equal(cache["v"].view(torch.uint8)[:, :12],
                       layers.cast_kv(v, FP8).view(torch.uint8))


def test_decode_writes_the_cast_row_in_place():
    cfg = _fp8_cfg()
    params = init_params(cfg, 0, device="cpu")
    layer = {n: t[0] for n, t in params["blocks"][0].items()}
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 12, cfg.d_model, generator=g)
    pos = torch.arange(12, dtype=torch.int32)
    _, cache = layers.attn_apply(layer, x, "full", cfg, pos,
                                 want_cache=True, max_seq=16)
    ring = cache["k"]
    before = ring.view(torch.uint8).clone()
    x1 = torch.randn(2, 1, cfg.d_model, generator=g)
    _, new = layers.attn_decode(layer, x1, cache, "full", cfg, 12)
    assert new["k"] is ring
    after = ring.view(torch.uint8)
    changed = (after != before).flatten(2).any(-1)  # (B, W)
    assert changed[:, 12].all()
    changed[:, 12] = False
    assert not changed.any()
    # the written row is cast_kv of the token's roped K
    h = layers.rms_norm(x1, layer["norm"], cfg.norm_eps)
    _q, k, _v = layers._proj_qkv(h, layer, cfg)
    k = layers.rope(k, torch.full((1,), 12, dtype=torch.int32),
                    cfg.rope_theta)
    assert torch.equal(after[:, 12], layers.cast_kv(k[:, 0], FP8).view(
        torch.uint8))


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16])
def test_decode_plain_version_widens_the_float8_cache(qdt):
    g = torch.Generator().manual_seed(2)
    B, W, KH, G, D = 2, 20, 2, 4, 16
    q = torch.randn(B, 1, KH * G, D, generator=g).to(qdt)
    ck, cv = (torch.randn(B, W, KH, D, generator=g).to(FP8)
              for _ in range(2))
    got = da_ops.decode_attention(q, ck, cv, 25, window=0)
    want = da_ops.decode_attention(q, ck.to(qdt), cv.to(qdt), 25, window=0)
    assert got.dtype == qdt
    assert torch.equal(got, want)
    rows = da_ops.grouped_rows(q, KH)
    kf = ck.view(torch.uint8).transpose(1, 2).reshape(B * KH, W, D).view(FP8)
    vf = cv.view(torch.uint8).transpose(1, 2).reshape(B * KH, W, D).view(FP8)
    valid = da_ref.ring_validity(W, 25)[None].expand(B * KH, W)
    assert torch.equal(da_ref.decode_attention_ref(rows, kf, vf, valid),
                       got.reshape(B * KH, G, D))


def test_convert_takes_float8_leaves_by_their_bits():
    bits = np.arange(256, dtype=np.uint8).reshape(4, 64)
    a = bits.view(ml_dtypes.float8_e4m3fn)
    t = convert.model_params_from_numpy({"k": a}, "cpu")["k"]
    assert t.dtype == FP8
    assert torch.equal(t.view(torch.uint8), torch.from_numpy(bits))
