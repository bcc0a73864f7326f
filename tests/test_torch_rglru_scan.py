"""The port's RG-LRU recurrence (`repro_torch.kernels.rglru_scan`) and
recurrent block (`repro_torch.models.layers.rglru_apply`, `rglru_decode`)
against the reference's, on the CPU, where the wrapper runs the kernel's
plain log-step scan.

References: `repro.kernels.rglru_scan.ref.rglru_scan_ref` (the
associative scan), the Pallas `rglru_scan_fwd` in interpret mode, as the
reference's own tests run it on the CPU (small tiles, so ragged S and W
take its padding path), and the recurrence step by step in float64
(`rglru_sequential_ref`).  The CUDA kernel's own order
(`rglru_tiled_ref`) is held to the same references, and its launch
geometry (`ops.launch_geometry`) to covering every step and channel
once.  Inputs come from numpy seeds: a in (0, 1), as
the model's gates give it, b standard normal.

Tolerances: the recurrence is contractive (0 < a < 1), so each float32
form stays within a few roundings of |h| of the exact one: every form to
1e-5 times max(1, max |h|) absolute (measured below 5e-7 at |h| ~ 5).  The
recurrent block in float32 (its projections, gates and scan) to 5e-5
absolute, as `tests/test_torch_models.py` bounds float32 layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models as ref_models
from repro.kernels.rglru_scan.ref import rglru_scan_ref as ref_scan
from repro.kernels.rglru_scan.rglru_scan import rglru_scan_fwd as pallas_fwd
from repro.models import layers as ref_layers
from repro_torch import configs, convert
from repro_torch.kernels.rglru_scan import ops, ref
from repro_torch.models import layers

F32_ATOL = 5e-5


def _inputs(seed, B, S, W, lo=0.0):
    """(a, b) float32 numpy arrays, a uniform in (lo, 1)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 1.0, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b


def _assert_scan_close(got, want, exact):
    """``got`` and ``want`` within 1e-5 max(1, max |h|) of the float64
    ``exact`` and of each other."""
    tol = 1e-5 * max(1.0, float(np.abs(exact).max()))
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - exact).max() <= tol, np.abs(got - exact).max()
    assert np.abs(want - exact).max() <= tol, np.abs(want - exact).max()
    assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _exact(a, b):
    return ref.rglru_sequential_ref(torch.as_tensor(a),
                                    torch.as_tensor(b)).numpy()


@pytest.mark.parametrize("B,S,W,lo", [(2, 64, 16, 0.0), (1, 1, 5, 0.0),
                                      (3, 2, 7, 0.0), (2, 129, 40, 0.9),
                                      (1, 300, 3, 0.99)])
def test_plain_scan_matches_reference_scan(B, S, W, lo):
    """Sequence lengths at and around powers of two (the log-step scan's
    last step), S = 1, and slow decays (a near 1) that carry a value far."""
    a, b = _inputs(S + W, B, S, W, lo)
    ops.reset_launches()
    got = ops.rglru_scan_fwd(torch.as_tensor(a), torch.as_tensor(b))
    assert ops.rglru_scan_fwd.launches == 0         # the plain version ran
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    want = ref_scan(jnp.asarray(a), jnp.asarray(b))
    _assert_scan_close(got.numpy(), want, _exact(a, b))
    torch.testing.assert_close(
        ops.rglru_scan(torch.as_tensor(a), torch.as_tensor(b)), got,
        rtol=0, atol=0)
    torch.testing.assert_close(
        ref.rglru_scan_ref(torch.as_tensor(a), torch.as_tensor(b)), got,
        rtol=0, atol=0)


@pytest.mark.parametrize("B,S,W", [(2, 50, 24), (1, 33, 17)])
def test_plain_scan_matches_pallas_interpret(B, S, W):
    """Ragged S and W against 16 x 16 tiles: the Pallas kernel pads both."""
    a, b = _inputs(7, B, S, W)
    got = ops.rglru_scan_fwd(torch.as_tensor(a), torch.as_tensor(b))
    want = pallas_fwd(jnp.asarray(a), jnp.asarray(b), bs=16, bw=16,
                      interpret=True)
    _assert_scan_close(got.numpy(), want, _exact(a, b))


# ---------------------------------------------------------------------------
# the kernel's own order (`rglru_tiled_ref`) and its launch geometry
# ---------------------------------------------------------------------------
def _tiling(C, L):
    """(tile, split) of the kernel instance with C channels and L steps."""
    return L, ops.THREADS // C


# (B, S, W, a's lower end, C, L): S at 1, L - 1, L, L + 1 and several
# tiles, with a sub-chunk boundary (L / split steps) on the last step; W
# no multiple of C; slow decay over > 2000 steps
TILED_CASES = [
    (2, 1, 37, 0.0, 32, 64),
    (2, 63, 37, 0.0, 32, 64),
    (1, 64, 40, 0.0, 32, 64),
    (2, 65, 33, 0.5, 32, 64),
    (1, 3 * 64 + 5 * 8, 70, 0.0, 32, 64),      # 3 tiles + 5 sub-chunks
    (1, 2 * 256 + 3 * 16, 21, 0.9, 16, 256),   # 2 tiles + 3 sub-chunks
    (1, 511, 13, 0.0, 8, 512),
    (2, 513, 13, 0.0, 8, 512),
    (1, 2 * 512 + 7 * 16, 9, 0.9, 8, 512),     # 2 tiles + 7 sub-chunks
    (1, 2085, 7, 0.99, 32, 64),                # 33 tiles, a near 1
    (1, 2085, 7, 0.99, 8, 512),
]


@pytest.mark.parametrize("B,S,W,lo,C,L", TILED_CASES)
def test_tiled_order_matches_reference_scan(B, S, W, lo, C, L):
    """The kernel's association against the reference's associative scan
    and the float64 recurrence, within 1e-5 max(1, max |h|)."""
    a, b = _inputs(S * 7 + W, B, S, W, lo)
    tile, split = _tiling(C, L)
    got = ref.rglru_tiled_ref(torch.as_tensor(a), torch.as_tensor(b),
                              tile=tile, split=split)
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    want = ref_scan(jnp.asarray(a), jnp.asarray(b))
    _assert_scan_close(got.numpy(), want, _exact(a, b))


def _serial_fma(a, b):
    """The recurrence step by step, each step one `ref._fma`."""
    h = torch.zeros_like(a[:, 0])
    out = []
    for t in range(a.shape[1]):
        h = ref._fma(a[:, t], h, b[:, t])
        out.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("tile,split", [(64, 1), (8, 8), (16, 16)])
def test_tiled_order_degenerates_to_the_serial_recurrence(tile, split):
    """One sub-chunk covering the whole sequence, or sub-chunks of one
    step (the fold is then the recurrence itself), give the serial FMA
    recurrence bitwise."""
    a, b = (torch.as_tensor(v) for v in _inputs(5, 2, 40, 6))
    got = ref.rglru_tiled_ref(a, b, tile=tile, split=split)
    torch.testing.assert_close(got, _serial_fma(a, b), rtol=0, atol=0)


def test_tiled_order_checks_its_tiling():
    a = torch.rand(1, 8, 2)
    with pytest.raises(ValueError, match="multiple"):
        ref.rglru_tiled_ref(a, a, tile=12, split=8)


def test_fma_rounds_once():
    """`_fma` keeps the product exact: 1 + 2^-23 squared minus 1 is 2^-22
    + 2^-46 exactly, which float32 holds; a multiply, then an add, loses
    the 2^-46."""
    a = torch.tensor([1.0 + 2.0 ** -23])
    c = torch.tensor([-1.0 - 2.0 ** -22])
    assert ref._fma(a, a, c).item() == 2.0 ** -46
    assert (a * a + c).item() == 0.0


# the smoke's shapes (recurrentgemma-9b's forward, prefill of 4 and of 1
# prompts, the ragged ones) and edges of the channel-group choice
GEOMETRY_SHAPES = {
    (2, 4096, 4096): (32, 64, 2),
    (4, 2100, 4096): (32, 64, 2),
    (1, 2100, 4096): (32, 64, 4),
    (1, 2085, 999): (8, 512, 4),
    (1, 2085, 1000): (8, 512, 4),
    (1, 1, 1): (8, 512, 4),
    (1, 333, 77): (8, 512, 4),
    (1, 300, 1100): (16, 256, 4),
    (3, 40, 4096): (32, 64, 2),
    (6, 257, 4096): (32, 64, 2),
    (1, 65, 2112): (32, 64, 4),                 # 66 CTAs of 32 channels
    (1, 65, 2080): (16, 256, 4),                # 65 CTAs of 32 channels
    (64, 3, 5): (8, 512, 4),
}


@pytest.mark.parametrize("shape", sorted(GEOMETRY_SHAPES))
def test_launch_geometry_covers_every_step_and_channel_once(shape):
    """The launch's CTAs (batch row, channel group) and each CTA's tiles,
    sub-chunks and steps, as the kernel indexes them, own every (b, t, w)
    of the call exactly once, within a compiled instance that fits a
    CTA's shared memory."""
    B, S, W = shape
    g = ops.launch_geometry(B, S, W)
    assert g == ops.launch_geometry(B, S, W)           # a pure function
    assert (g.channels, g.steps, g.stages) == GEOMETRY_SHAPES[shape]
    assert (g.channels, g.steps, g.stages) in ops.INSTANCES
    assert g.split * g.channels == ops.THREADS and g.steps % g.split == 0
    assert g.smem <= ops.MAX_SMEM
    groups = -(-W // g.channels)
    assert g.ctas == B * groups
    # channels: CTA -> (row, c0); thread channel c < C, stored if < W
    own_bw = np.zeros((B, W), np.int64)
    for cta in range(g.ctas):
        row, c0 = divmod(cta, groups)
        cols = c0 * g.channels + np.arange(g.channels)
        np.add.at(own_bw[row], cols[cols < W], 1)
    # steps: tile n, sub-chunk k, step i of the sub-chunk, stored if < S
    sub = g.steps // g.split
    n, k, i = np.meshgrid(np.arange(-(-S // g.steps)), np.arange(g.split),
                          np.arange(sub), indexing="ij")
    t = (n * g.steps + k * sub + i).ravel()
    own_t = np.bincount(t[t < S], minlength=S)
    assert (own_bw == 1).all() and (own_t == 1).all()


def test_every_instance_fits_a_cta():
    """Every compiled instance's shared memory (the ring of a and x tiles
    and the (P, H) pairs) stays within a CTA's 227 KB."""
    for inst in ops.INSTANCES:
        g = ops.geometry_of(1, 4096, *inst)
        assert g.smem <= ops.MAX_SMEM, inst
        assert g.split * g.channels == ops.THREADS and g.steps % g.split == 0
    with pytest.raises(ValueError, match="no compiled"):
        ops.geometry_of(1, 64, 32, 96, 2)


def test_sequential_oracle_is_the_recurrence():
    a, b = _inputs(1, 2, 5, 3)
    h = np.zeros((2, 3))
    want = []
    for t in range(5):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        want.append(h)
    got = ref.rglru_sequential_ref(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_wrapper_checks_its_inputs():
    a = torch.rand(2, 8, 4)
    with pytest.raises(ValueError, match="shape"):
        ops.rglru_scan_fwd(a, a[:, :7].contiguous())
    with pytest.raises(ValueError, match="shape"):
        ops.rglru_scan_fwd(a[0], a[0])
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan_fwd(a.double(), a.double())
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan_fwd(a, a.bfloat16())
    strided = a.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan_fwd(strided, a)
    with pytest.raises(ValueError, match="no rglru_scan kernel for meta"):
        ops.rglru_scan_fwd(a.to("meta"), a.to("meta"))
    ops.reset_launches()
    assert ops.rglru_scan_fwd(a[:, :0], a[:, :0]).shape == (2, 0, 4)
    assert ops.rglru_scan_fwd.launches == 0


# ---------------------------------------------------------------------------
# the recurrent block against the reference's
# ---------------------------------------------------------------------------
def _block_case(seed=3, S=11):
    """The SMOKE model's first recurrent layer (float32) from the
    reference's `init_params`, both packages' copies, and an input."""
    rcfg = dataclasses.replace(
        ref_configs.get_smoke_config("recurrentgemma_9b"), dtype="float32")
    cfg = dataclasses.replace(
        configs.get_smoke_config("recurrentgemma_9b"), dtype="float32")
    params = ref_models.init_params(rcfg, jax.random.key(seed))
    rp = {k: v[0] for k, v in params["blocks"][0].items()}
    tp = {k: torch.as_tensor(np.array(v)) for k, v in rp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, tp, x


def test_param_defs_match_reference():
    rcfg, cfg, rp, tp, _ = _block_case()
    defs = layers.rglru_param_defs(cfg)
    want = ref_layers.rglru_param_defs(rcfg)
    assert defs == want
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: shape for k, (shape, _ax) in
        {**defs, **layers.ffn_param_defs(cfg, "swiglu")}.items()}
    assert layers._LRU_C == ref_layers._LRU_C


def test_gates_match_reference():
    _, _, rp, tp, x = _block_case()
    u = x[..., :rp["a_param"].shape[0]]
    a, g = layers._rglru_gates(tp, torch.as_tensor(u))
    ra, rg = ref_layers._rglru_gates(rp, jnp.asarray(u))
    assert a.dtype == g.dtype == torch.float32
    assert float(a.min()) > 0.0 and float(a.max()) < 1.0
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), rtol=0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
def test_rglru_apply_matches_reference(impl):
    rcfg, cfg, rp, tp, x = _block_case()
    want, wcache = ref_layers.rglru_apply(rp, jnp.asarray(x), rcfg,
                                          want_cache=True)
    ops.reset_launches()
    got, cache = layers.rglru_apply(tp, torch.as_tensor(x), cfg, impl=impl,
                                    want_cache=True)
    assert ops.rglru_scan_fwd.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    assert sorted(cache) == sorted(wcache) == ["conv", "state"]
    for name in cache:
        assert cache[name].is_contiguous()
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(wcache[name]), rtol=0,
                                   atol=F32_ATOL, err_msg=name)
    assert layers.rglru_apply(tp, torch.as_tensor(x), cfg)[1] is None
    with pytest.raises(ValueError, match="impl"):
        layers.rglru_apply(tp, torch.as_tensor(x), cfg, impl="scan")


def test_rglru_decode_matches_reference():
    """Three steps from the reference's prefill cache of 11 tokens."""
    rcfg, cfg, rp, tp, x = _block_case(S=14)
    _, rcache = ref_layers.rglru_apply(rp, jnp.asarray(x[:, :11]), rcfg,
                                       want_cache=True)
    cache = {k: torch.as_tensor(np.array(v)) for k, v in rcache.items()}
    for t in range(11, 14):
        want, rcache = ref_layers.rglru_decode(rp, jnp.asarray(x[:, t:t + 1]),
                                               rcache, rcfg, t)
        got, cache = layers.rglru_decode(tp, torch.as_tensor(x[:, t:t + 1]),
                                         cache, cfg, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_ATOL)
        for name in ("state", "conv"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(rcache[name]), rtol=0,
                                       atol=F32_ATOL, err_msg=name)


def test_block_dispatch_runs_rglru_with_the_chosen_scan(monkeypatch):
    """`block_apply` reaches the kernel entry under ``impl="pallas"`` and
    the plain scan under ``"jnp"``; `block_decode` neither."""
    _, cfg, _, tp, x = _block_case()
    calls = []
    for name in ("rglru_scan", "rglru_scan_ref"):
        real = getattr(layers, name)
        monkeypatch.setattr(layers, name,
                            lambda *a, _n=name, _r=real: (calls.append(_n),
                                                          _r(*a))[1])
    xt = torch.as_tensor(x)
    pos = torch.arange(x.shape[1])
    for impl in ("pallas", "jnp"):
        calls.clear()
        y, cache = layers.block_apply(tp, xt, "rglru", "swiglu", cfg, pos,
                                      impl=impl, want_cache=True)
        assert calls == [{"pallas": "rglru_scan",
                          "jnp": "rglru_scan_ref"}[impl]]
        assert y.shape == xt.shape
    calls.clear()
    layers.block_decode(tp, xt[:, :1], cache, "rglru", "swiglu", cfg, 11)
    assert calls == []


def test_convert_carries_rglru_params_and_cache():
    """`model_params_from_numpy` and `cache_from_numpy` carry every
    recurrent leaf (names, shapes, dtypes, values) of the reference's
    SMOKE parameters and prefill cache."""
    rcfg = ref_configs.get_smoke_config("recurrentgemma_9b")
    cfg = configs.get_smoke_config("recurrentgemma_9b")
    params = jax.tree.map(np.asarray,
                          ref_models.init_params(rcfg, jax.random.key(1)))
    got = convert.model_params_from_numpy(params, device="cpu")
    for k in (0, 1):
        for name, leaf in params["blocks"][k].items():
            t = got["blocks"][k][name]
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), leaf, err_msg=name)
    assert sorted(got["tail"][1]) == sorted(params["tail"][1])
    cache = jax.tree.map(np.array, ref_models.init_cache(rcfg, 2, 16))
    cache["blocks"][0]["state"][:] = np.arange(
        cache["blocks"][0]["state"].size).reshape(
            cache["blocks"][0]["state"].shape)
    port = convert.cache_from_numpy(cache, cfg, device="cpu")
    assert port["blocks"][0]["state"].dtype == torch.float32
    assert port["blocks"][0]["conv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(port["blocks"][0]["state"].numpy(),
                                  cache["blocks"][0]["state"])
    assert tuple(port["tail"][0]["conv"].shape) == (2, 3, cfg.lru_width)
