"""Dense LM forward of the port (`repro.models.model`'s `init_params`,
`forward` and `logits_from_h`).

Layout: ``num_layers = n_cycles * len(pattern) + tail``.  The parameters
keep the reference's pytree: ``embed`` (V, D), ``unembed`` (D, V),
``final_norm`` (D,), ``blocks`` — one dict per pattern position, each leaf
stacked over the cycles — and ``tail``, one unstacked dict per tail layer.
Where the reference scans over the stacked cycles (`lax.scan`), `forward`
runs a Python loop over them and then over the tail.  A plain large
matrix product (the projections, ``h @ unembed``) stays `torch.matmul`;
attention is the flash kernel (`layers.attention`).

Prefill, decoding, the loss and the encoder are not ported yet
(ROADMAP §1 item 12).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Union

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import NEG_INF, block_apply, block_param_defs, rms_norm

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string ("bfloat16", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _init_leaf(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in), fan_in as the reference computes it (the
    leading dims of a >= 2-d leaf, stacking axis included)."""
    fan_in = shape[0] if len(shape) == 1 else int(np.prod(shape[:-1]))
    t = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return t.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(device)


def _block_params(gen, defs, n_stack: int, dtype, device) -> Params:
    return {name: _init_leaf(gen, ((n_stack,) + shape if n_stack else shape),
                             dtype, device)
            for name, shape in sorted(defs.items())}


def init_params(cfg: ModelConfig, generator: Union[int, torch.Generator],
                device: DeviceLike = None) -> Params:
    """Random parameters in the reference's layout and scale.

    ``generator`` is a `torch.Generator` or an integer seed (a generator
    on ``device`` is then made from it); leaves are drawn in a fixed order
    (embed, unembed, then each pattern position's and tail layer's leaves
    by name).  `torch` and `jax.random` give different numbers from one
    seed: carry the reference's parameters across with
    `convert.model_params_from_numpy` to compute the same thing."""
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models are not ported "
                                  "yet (ROADMAP §1 item 12: enc-dec)")
    dev = resolve_device(device)
    gen = (torch.Generator(device=dev).manual_seed(generator)
           if isinstance(generator, int) else generator)
    pd = torch_dtype(cfg.param_dtype)
    n_cycles, tail = cfg.cycles_and_tail
    V, D = cfg.padded_vocab, cfg.d_model
    params: Params = {
        "embed": _init_leaf(gen, (V, D), pd, dev),
        "unembed": _init_leaf(gen, (D, V), pd, dev),
        "final_norm": torch.zeros((D,), dtype=pd, device=dev),
    }
    params["blocks"] = tuple(
        _block_params(gen, block_param_defs(cfg, mixer, ffn), n_cycles, pd,
                      dev)
        for mixer, ffn in cfg.pattern)
    params["tail"] = tuple(
        _block_params(gen, block_param_defs(cfg, *cfg.pattern[t]), 0, pd,
                      dev)
        for t in range(tail))
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _embed_inputs(params: Params, batch, cfg: ModelConfig) -> torch.Tensor:
    if cfg.num_patches and "patch_embeds" in batch:
        raise NotImplementedError("patch embeddings are not ported yet "
                                  "(ROADMAP §1 item 12: vlm)")
    table = params["embed"]
    tokens = torch.as_tensor(batch["tokens"], device=table.device)
    return table[tokens.long()].to(torch_dtype(cfg.dtype))


def forward(params: Params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Final hidden states (B, S, D) in the compute dtype — logits via
    `logits_from_h`.  ``batch["tokens"]`` is (B, S) integers."""
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    n_cycles, tail = cfg.cycles_and_tail
    for c in range(n_cycles):
        for k, (mixer, ffn) in enumerate(cfg.pattern):
            layer = {n: t[c] for n, t in params["blocks"][k].items()}
            x = block_apply(layer, x, mixer, ffn, cfg, positions)
    for t in range(tail):
        mixer, ffn = cfg.pattern[t]
        x = block_apply(params["tail"][t], x, mixer, ffn, cfg, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_from_h(params: Params, h: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """float32 logits (B, S, V_padded); the vocabulary padding is masked
    to -1e30."""
    logits = (h @ params["unembed"].to(h.dtype)).float()
    pad = cfg.padded_vocab - cfg.vocab_size
    if pad:
        logits[..., cfg.vocab_size:] = NEG_INF
    return logits
