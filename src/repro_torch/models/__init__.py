"""The LM of the port (`repro.models`): forward, generation and the loss.

Ported: `ModelConfig` and its constructors (`config`); the layers
(`layers`: norms, RoPE, GQA self- and cross-attention on the flash
kernel, the ring-buffer KV cache (bfloat16, float32 or float8_e4m3fn)
with flash-decode, SwiGLU, GELU and MoE FFNs, the Mamba2 SSD mixer on
the SSD scan kernel, the RG-LRU mixer on the RG-LRU recurrence kernel,
and under autograd their plain paths and the `grad_dtype_barrier`);
`init_params` / `param_shapes` / `forward` / `logits_from_h` /
`loss_fn` and the generation path `init_cache` / `prefill` /
`decode_step` (`model`), the encoder of an encoder-decoder, a VLM's
patch embeddings, ``cfg.remat`` and ``cfg.logit_chunk`` included; and
the sharding metadata, `param_axes`, `cache_axes` and `cache_specs`: the
logical axes of every parameter and cache leaf (`layers`' parameter
definitions carry them) and the cache's shapes on the ``meta`` device.
"""
from .config import ModelConfig, dense_lm, moe_lm, pad_vocab
from .model import (cache_axes, cache_specs, decode_step, forward,
                    init_cache, init_params, logits_from_h, loss_fn,
                    param_axes, param_shapes, prefill)

__all__ = ["ModelConfig", "dense_lm", "moe_lm", "pad_vocab", "init_params",
           "param_axes", "param_shapes", "forward", "logits_from_h",
           "loss_fn", "prefill", "decode_step",
           "init_cache", "cache_specs", "cache_axes"]
