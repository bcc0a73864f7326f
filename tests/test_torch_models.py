"""The port's dense LM (`repro_torch.models`, `repro_torch.configs`,
`repro_torch.data.pipeline`) against the reference's, on the CPU.

* Configurations: every field, property, `param_count` and `layer_kind`
  of paper_edge's CONFIG, ED_VARIANTS and SMOKE and gemma3-1b's CONFIG and
  SMOKE equal the reference's, as do `scaled` variants.
* Forward: the reference's `init_params` pytree is carried across with
  `convert.model_params_from_numpy`, and `forward` + `logits_from_h` of
  both packages run on the same tokens at the SMOKE sizes (paper_edge: 2
  layers; gemma3-1b: 14 layers of the 5:1 local/global pattern, window 8,
  so 24 tokens cross the window).  The reference runs with
  ``attn_impl="dense"`` and with ``"pallas"`` (interpret mode); the port
  with its dense path and with its flash path (the kernel's plain version
  on the CPU).
  Tolerances: float32 logits to 5e-5 absolute (measured ~6e-6: float32
  matrix products summed in other orders).  bfloat16 logits (scale ~4)
  to 0.25 absolute and 0.02 mean absolute, with top-1 equal on at least
  85% of positions: bfloat16 keeps 8 bits, the two frameworks round at
  different places (XLA may keep excess precision between fused
  elementwise ops) over up to 14 layers, and untrained models have close
  runner-up logits; measured max 0.11 and top-1 >= 91.7%.
* `init_params` of the port: the reference's layout, float32, zero final
  norm and the 1/sqrt(fan_in) scale, checked on the sample std.
* `TokenPipeline`: bitwise the reference's tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro_torch import configs, convert
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import (dense_lm, forward, init_params,
                                layers, logits_from_h, moe_lm)

ARCHS = ("paper_edge", "gemma3_1b")
F32_ATOL = 5e-5
BF16_ATOL, BF16_MEAN, BF16_TOP1 = 0.25, 0.02, 0.85


def _named_configs():
    out = {}
    for arch in ARCHS:
        rmod = __import__(f"repro.configs.{arch}", fromlist=["x"])
        pmod = __import__(f"repro_torch.configs.{arch}", fromlist=["x"])
        for name in ("CONFIG", "SMOKE"):
            out[f"{arch}.{name}"] = (getattr(rmod, name), getattr(pmod, name))
    for i in range(2):
        out[f"paper_edge.ED_VARIANTS[{i}]"] = (
            ref_configs.paper_edge.ED_VARIANTS[i],
            configs.paper_edge.ED_VARIANTS[i])
    return out


CONFIGS = _named_configs()


def _assert_same_config(ref_cfg, cfg):
    assert type(cfg).__module__.startswith("repro_torch")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    for prop in ("padded_vocab", "d_inner", "cycles_and_tail", "is_encdec"):
        assert getattr(cfg, prop) == getattr(ref_cfg, prop), prop
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    assert [cfg.layer_kind(i) for i in range(cfg.num_layers + 2)] == \
        [ref_cfg.layer_kind(i) for i in range(ref_cfg.num_layers + 2)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_reference(name):
    _assert_same_config(*CONFIGS[name])


@pytest.mark.parametrize("width,depth", [(0.25, 1.0), (0.5, 1.0),
                                         (0.75, 0.5), (2.0, 0.3)])
@pytest.mark.parametrize("arch", ARCHS)
def test_scaled_matches_reference(arch, width, depth):
    ref_cfg, cfg = CONFIGS[f"{arch}.CONFIG"]
    _assert_same_config(ref_cfg.scaled(width, depth),
                        cfg.scaled(width, depth))


def test_family_constructors_match_reference():
    _assert_same_config(
        ref_models.dense_lm("d", 4, 256, 8, 2, 512, 1000, mixer="swa"),
        dense_lm("d", 4, 256, 8, 2, 512, 1000, mixer="swa"))
    _assert_same_config(ref_models.moe_lm("m", 2, 128, 4, 4, 64, 500, 8, 2),
                        moe_lm("m", 2, 128, 4, 4, 64, 500, 8, 2))
    assert configs.ARCHS == ref_configs.ARCHS


def test_get_config_ports_dense_archs_and_names_the_rest():
    """Every architecture of the reference's registry: CONFIG and SMOKE
    equal the reference's by either spelling, `all_archs` as the
    reference's; an unknown name raises."""
    assert configs.ARCHS == ref_configs.ARCHS and len(configs.ARCHS) == 11
    assert configs.all_archs() == ref_configs.all_archs()
    for arch in configs.ARCHS:
        _assert_same_config(ref_configs.get_config(arch),
                            configs.get_config(arch.replace("_", "-")))
        _assert_same_config(ref_configs.get_smoke_config(arch),
                            configs.get_smoke_config(arch))
    with pytest.raises(ValueError, match="unknown architecture"):
        configs.get_config("gpt2")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, ref_impl):
    """(reference params as numpy, tokens, reference logits)."""
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch),
                              dtype=dtype, attn_impl=ref_impl)
    params = ref_models.init_params(cfg, jax.random.key(1))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    h = ref_models.forward(params, {"tokens": jnp.asarray(tokens)}, cfg)
    logits = ref_models.logits_from_h(params, h, cfg)
    return (jax.tree.map(np.asarray, params), tokens,
            np.asarray(logits), np.asarray(h.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ref_impl,port_impl", [
    ("dense", "dense"), ("dense", "auto"), ("pallas", "auto")])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, ref_impl, port_impl, dtype):
    params_np, tokens, want, want_h = _reference(arch, dtype, ref_impl)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype,
                              attn_impl=port_impl)
    params = convert.model_params_from_numpy(params_np, device="cpu")
    fa_ops.reset_launches()
    h = forward(params, {"tokens": torch.as_tensor(tokens)}, cfg)
    got = logits_from_h(params, h, cfg)
    assert h.dtype == getattr(torch, dtype) and got.dtype == torch.float32
    assert got.shape == want.shape
    assert fa_ops.flash_attention_fwd.launches == 0
    V = cfg.vocab_size
    got = got.numpy()
    np.testing.assert_array_equal(got[..., V:], want[..., V:])  # -1e30 pad
    got, want = got[..., :V], want[..., :V]
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= F32_ATOL, err.max()
        np.testing.assert_allclose(h.float().numpy(), want_h, rtol=0,
                                   atol=F32_ATOL)
    else:
        top1 = (got.argmax(-1) == want.argmax(-1)).mean()
        assert err.max() <= BF16_ATOL and err.mean() <= BF16_MEAN \
            and top1 >= BF16_TOP1, (err.max(), err.mean(), top1)


def test_forward_routes_attention_by_attn_impl(monkeypatch):
    """``auto`` / ``chunked`` / ``pallas`` reach the flash entry on every
    layer, ``dense`` never does; another name raises."""
    cfg = configs.get_smoke_config("gemma3_1b")
    params = init_params(cfg, 0, device="cpu")
    calls = []
    real = layers.flash_attention

    def spy(*a, **k):
        calls.append(k["mask_kind"])
        return real(*a, **k)

    monkeypatch.setattr(layers, "flash_attention", spy)
    batch = {"tokens": torch.zeros((1, 12), dtype=torch.int64)}
    for impl, n in (("auto", 14), ("chunked", 14), ("pallas", 14),
                    ("dense", 0)):
        calls.clear()
        forward(params, batch, dataclasses.replace(cfg, attn_impl=impl))
        assert len(calls) == n, impl
    forward(params, batch, dataclasses.replace(cfg, attn_impl="auto"))
    assert calls.count("window") == 12 and calls.count("causal") == 2
    with pytest.raises(ValueError, match="attn_impl"):
        forward(params, batch, dataclasses.replace(cfg, attn_impl="ring"))


def _leaves(tree, path=""):
    """(path, leaf) pairs of a params tree of dicts and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def _shapes(tree):
    return {p: tuple(leaf.shape) for p, leaf in _leaves(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_dtype_and_scale(arch):
    cfg = configs.get_smoke_config(arch)
    params = init_params(cfg, 5, device="cpu")
    ref_shapes = ref_models.param_shapes(ref_configs.get_smoke_config(arch))
    assert _shapes(params) == _shapes(ref_shapes)
    assert torch.equal(params["final_norm"], torch.zeros(cfg.d_model))
    for _path, t in _leaves(params):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    # 1/sqrt(fan_in), fan_in the leading dims (stacking axis included)
    for leaf, name in ((params["embed"], "embed"),
                       (params["unembed"], "unembed"),
                       (params["blocks"][0]["wi_gate"], "wi_gate"),
                       (params["blocks"][0]["wo"], "wo")):
        shape = leaf.shape
        fan_in = shape[0] if len(shape) == 1 else int(np.prod(shape[:-1]))
        std = float(leaf.std()) * np.sqrt(fan_in)
        assert abs(std - 1.0) < 0.1, (name, std)
    again = init_params(cfg, 5, device="cpu")
    assert torch.equal(again["blocks"][0]["wq"], params["blocks"][0]["wq"])
    other = init_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    assert not torch.equal(other["embed"], params["embed"])


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (2048, 64, 16, 7), (256, 24, 4, 0), (262144, 2048, 2, 3), (50, 7, 3, 1)])
def test_token_pipeline_matches_reference_bitwise(vocab, seq, batch, seed,
                                                  rank, world):
    if batch % world:
        with pytest.raises(ValueError):
            TokenPipeline(DataConfig(vocab, seq, batch, seed), rank=rank,
                          world=world)
        return
    ref = RefTokenPipeline(RefDataConfig(vocab, seq, batch, seed),
                           rank=rank, world=world)
    got = TokenPipeline(DataConfig(vocab, seq, batch, seed), rank=rank,
                        world=world)
    for step in (0, 1, 100):
        a, b = got.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert next(iter(got))["tokens"].shape == (batch // world, seq)
