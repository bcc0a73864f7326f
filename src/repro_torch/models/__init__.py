"""The LM of the port (`repro.models`): forward and generation.

Ported: `ModelConfig` and its constructors (`config`); the layers
(`layers`: norms, RoPE, GQA self- and cross-attention on the flash
kernel, the ring-buffer KV cache (bfloat16, float32 or float8_e4m3fn)
with flash-decode, SwiGLU, GELU and MoE FFNs, the Mamba2 SSD mixer on
the SSD scan kernel, the RG-LRU mixer on the RG-LRU recurrence kernel);
`init_params` / `forward` / `logits_from_h` and the generation path
`init_cache` / `prefill` / `decode_step` (`model`), the encoder of an
encoder-decoder and a VLM's patch embeddings included.  Not ported yet
(ROADMAP §1 item 12.5): the loss and training.
"""
from .config import ModelConfig, dense_lm, moe_lm, pad_vocab
from .model import (decode_step, forward, init_cache, init_params,
                    logits_from_h, prefill)

__all__ = ["ModelConfig", "dense_lm", "moe_lm", "pad_vocab", "init_params",
           "forward", "logits_from_h", "init_cache", "prefill",
           "decode_step"]
