"""The dense LM of the port (`repro.models`' forward path).

Ported: `ModelConfig` and its constructors (`config`), the dense layers
(`layers`: norms, RoPE, GQA self-attention on the flash kernel, SwiGLU and
GELU FFNs) and `init_params` / `forward` / `logits_from_h` (`model`).
Not ported yet (ROADMAP §1 item 12): MoE, the SSD and RG-LRU mixers,
cross-attention, prefill and decoding, the loss.
"""
from .config import ModelConfig, dense_lm, moe_lm, pad_vocab
from .model import forward, init_params, logits_from_h

__all__ = ["ModelConfig", "dense_lm", "moe_lm", "pad_vocab", "init_params",
           "forward", "logits_from_h"]
