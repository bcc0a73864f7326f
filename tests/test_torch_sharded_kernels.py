"""The kernels on a sharded program (ROADMAP §1 item 13): prefill and
decode on DTensor parameters over a (2, 2) ("data", "model") mesh of 4
gloo CPU ranks hand every kernel that the unsharded program reaches —
flash attention, flash-decode, the SSD scan, the RG-LRU scan — plain
local tensors (each rank's own rows), and give the unsharded program's
logits (float32, to 1e-5).  On the CPU each wrapper runs its plain
version; on the card the same calls launch the kernels (`chip_smoke.py`,
phase ``lm_sharded``).  ``attn_impl="pallas"`` under autograd raises, on
plain tensors and on a DTensor cache alike: the kernels have no backward
and nothing falls back to a plain path."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.ranks import run_ranks
from repro_torch.models import init_cache, init_params, layers

RANK_TIMEOUT_S = 240
ARCHS = {"internlm2_20b": ("flash_attention", "decode_attention"),
         "mamba2_130m": ("ssd_scan",),
         "recurrentgemma_9b": ("flash_attention", "decode_attention",
                               "rglru_scan")}
KERNELS = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan")
B, S, STEPS = 4, 12, 2
LOGIT_ATOL = 1e-5


def _cfg(arch, attn_impl="auto"):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               attn_impl=attn_impl)


def _generate(params, cfg, tokens, nxt):
    """Prefill, then ``STEPS`` decode steps: the logits of each."""
    from repro_torch.distributed.sharding import whole
    from repro_torch.models import decode_step, prefill
    with torch.no_grad():
        cache, logits = prefill(params, {"tokens": tokens}, cfg,
                                max_seq=S + STEPS)
        out = [logits]
        for t in range(STEPS):
            logits, cache = decode_step(params, nxt[:, t:t + 1], cache, cfg)
            out.append(logits)
    return [whole(x).numpy() for x in out]


def _refused(fn) -> str:
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return ""


def _sharded_rank(rank, world):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decode_step, forward, param_axes, prefill
    mesh = make_mesh((2, 2), ("data", "model"))
    rules = sh.base_rules()
    seen = {k: [] for k in KERNELS}

    def spy(name, fn):
        def run(*args, **kwargs):
            seen[name].append(any(isinstance(a, DTensor) for a in args))
            return fn(*args, **kwargs)
        return run
    for name in KERNELS:
        setattr(layers, name, spy(name, getattr(layers, name)))
    out = {}
    for arch in ARCHS:
        for v in seen.values():
            v.clear()
        cfg = _cfg(arch)
        params = init_params(cfg, 0, device="cpu")
        rng = np.random.default_rng(0)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
        nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, STEPS)))
        want = _generate(params, cfg, tokens, nxt)
        plain = {k: list(v) for k, v in seen.items()}
        for v in seen.values():
            v.clear()
        dparams = sh.distribute_tree(
            params, sh.tree_shardings(param_axes(cfg), mesh, rules))
        with sh.sharding_context(mesh, rules):
            got = _generate(dparams, cfg, tokens, nxt)
            sharded = {k: list(v) for k, v in seen.items()}
            # "pallas" under autograd, on sharded parameters: the
            # forward's kernels and the decode's flash-decode on a
            # DTensor cache refuse
            pcfg = _cfg(arch, "pallas")
            live = _requires_grad(dparams)
            with torch.no_grad():
                cache, _ = prefill(dparams, {"tokens": tokens}, pcfg,
                                   max_seq=S + STEPS)
            with torch.enable_grad():
                fwd = _refused(lambda: forward(live, {"tokens": tokens},
                                               pcfg))
                dec = _refused(lambda: decode_step(live, nxt[:, :1], cache,
                                                   pcfg))
        out[arch] = dict(
            err=[float(np.abs(g - w).max()) for g, w in zip(got, want)],
            plain=plain, sharded=sharded, refused_forward=fwd,
            refused_decode=dec)
    return out


def _requires_grad(tree):
    from repro_torch import _tree
    return _tree.tree_map(
        lambda t: t.detach().requires_grad_(True)
        if t.is_floating_point() else t, tree)


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_sharded_rank, 4, timeout=RANK_TIMEOUT_S)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_generation_runs_the_kernels_on_local_rows(ranks, arch):
    for res in ranks:
        r = res[arch]
        for name in KERNELS:
            called = name in ARCHS[arch]
            # the unsharded program reaches exactly the arch's kernels,
            # and the sharded one the same kernels, as often, never with
            # a DTensor
            assert bool(r["plain"][name]) == called, (name, r["plain"])
            assert len(r["sharded"][name]) == len(r["plain"][name]), name
            assert not any(r["sharded"][name]), name
        assert max(r["err"]) <= LOGIT_ATOL, r["err"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_pallas_refuses_autograd(ranks, arch):
    """The forward reaches a kernel in every arch (flash attention, or
    the SSD or RG-LRU scan); decode reaches one where it attends."""
    for res in ranks:
        r = res[arch]
        assert "has no backward" in r["refused_forward"], \
            r["refused_forward"]
        if "decode_attention" in ARCHS[arch]:
            assert "has no backward" in r["refused_decode"], \
                r["refused_decode"]


def test_pallas_decode_refuses_autograd_on_plain_tensors():
    """Before any kernel work: with grad enabled and an input requiring
    it, ``attn_impl="pallas"`` decode raises instead of taking the plain
    grouped path."""
    cfg = _cfg("internlm2_20b", "pallas")
    params = init_params(cfg, 0, device="cpu")
    p = {k: v[0] for k, v in params["blocks"][0].items()}
    cache = init_cache(cfg, 2, 8, device="cpu")
    ring = {k: v[0] for k, v in cache["blocks"][0].items()}
    x = torch.randn(2, 1, cfg.d_model, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        layers.attn_decode(p, x, ring, "full", cfg, 3)
