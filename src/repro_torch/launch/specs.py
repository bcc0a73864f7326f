"""The input-shape grid of the dry run, and stand-ins for every cell's
inputs (port of `repro.launch.specs`).

Shapes (LM grid — seq_len x global_batch):
  train_4k    : seq 4096,    batch 256   (training;      the train step)
  prefill_32k : seq 32768,   batch 32    (inference;     the prefill step)
  decode_32k  : seq 32768,   batch 128   (decode with a KV cache)
  long_500k   : seq 524288,  batch 1     (long-context decode)

`long_500k` needs sub-quadratic attention: it is skipped for the archs
whose every layer is full attention (internlm2, deepseek-coder, internvl2,
whisper) and run for the SSM, hybrid and windowed ones.  The stand-ins
are tensors on the ``meta`` device: shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..models import ModelConfig, cache_axes, cache_specs
from ..models.layers import torch_dtype

# the adopted performance overrides, applied by `dryrun --perf` and
# recorded apart from the paper-faithful baseline
PERF_OVERRIDES: Dict[tuple, Dict[str, str]] = {
    ("deepseek_coder_33b", "prefill_32k"): {"q_block": "4096",
                                            "attn_chunk": "512"},
    ("internlm2_20b", "prefill_32k"): {"q_block": "4096",
                                       "attn_chunk": "512"},
    ("internvl2_76b", "prefill_32k"): {"q_block": "4096",
                                       "attn_chunk": "512"},
}

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k":    dict(kind="train",   seq=4096,    batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,   batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,   batch=128),
    "long_500k":   dict(kind="decode",  seq=524288,  batch=1, long=True),
}

# archs whose every layer is unwindowed full attention: long_500k skipped
FULL_ATTENTION_ARCHS = frozenset({
    "internlm2_20b", "deepseek_coder_33b", "internvl2_76b", "whisper_base",
})


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch.replace("-", "_") in \
            FULL_ATTENTION_ARCHS:
        return False, "long_500k needs sub-quadratic attention (DESIGN.md)"
    return True, ""


def shape_overrides(cfg: ModelConfig, shape: str) -> ModelConfig:
    """Per-shape config adjustments (lowering hygiene, not architecture):
    chunked attention past 2048 tokens, bfloat16 weights for serving,
    full remat, a sequence-chunked loss and 2 or 4 microbatches for
    training."""
    info = SHAPES[shape]
    over = {}
    if info["kind"] in ("train", "prefill") and info["seq"] > 2048:
        over["attn_impl"] = "chunked"
    if info["kind"] in ("prefill", "decode"):
        over["param_dtype"] = "bfloat16"
    if info["kind"] == "train" and cfg.remat == "none":
        over["remat"] = "full"
    if info["kind"] == "train" and not cfg.logit_chunk:
        over["logit_chunk"] = 512
    if info["kind"] == "train" and cfg.microbatches == 1:
        over["microbatches"] = 4 if cfg.d_model >= 7168 else 2
    return dataclasses.replace(cfg, **over) if over else cfg


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """``meta`` tensors for every model input of this cell: the batch of
    a train or prefill step, the tokens and cache of a decode step."""
    info = SHAPES[shape]
    B, S = info["batch"], info["seq"]
    dt = torch_dtype(cfg.dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if info["kind"] in ("train", "prefill"):
        batch = {"tokens": meta((B, S), torch.int32)}
        if cfg.num_patches:
            batch["patch_embeds"] = meta((B, cfg.num_patches, cfg.d_model),
                                         dt)
        if cfg.is_encdec:
            batch["audio_feats"] = meta((B, cfg.encoder_seq, cfg.d_model),
                                        dt)
        return {"batch": batch}
    # decode: one new token against a seq-S cache
    return {"tokens": meta((B, 1), torch.int32),
            "cache": cache_specs(cfg, B, S)}


def batch_axes(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """Logical axes of the cell's inputs (mirrors `input_specs`)."""
    info = SHAPES[shape]
    if info["kind"] in ("train", "prefill"):
        axes = {"tokens": ("batch", "seq")}
        if cfg.num_patches:
            axes["patch_embeds"] = ("batch", None, "act_embed")
        if cfg.is_encdec:
            axes["audio_feats"] = ("batch", None, "act_embed")
        return {"batch": axes}
    return {"tokens": ("batch", None),
            "cache": cache_axes(cfg, info["batch"], info["seq"])}
