"""The LM of the port (`repro.models`): forward and generation.

Ported: `ModelConfig` and its constructors (`config`); the layers
(`layers`: norms, RoPE, GQA self-attention on the flash kernel, the
ring-buffer KV cache with flash-decode, SwiGLU and GELU FFNs, the Mamba2
SSD mixer on the SSD scan kernel, the RG-LRU mixer on the RG-LRU
recurrence kernel); `init_params` / `forward` / `logits_from_h` and the
generation path `init_cache` / `prefill` / `decode_step` (`model`).
Not ported yet (ROADMAP §1 item 12): MoE, cross-attention and the
encoder, the loss.
"""
from .config import ModelConfig, dense_lm, moe_lm, pad_vocab
from .model import (decode_step, forward, init_cache, init_params,
                    logits_from_h, prefill)

__all__ = ["ModelConfig", "dense_lm", "moe_lm", "pad_vocab", "init_params",
           "forward", "logits_from_h", "init_cache", "prefill",
           "decode_step"]
