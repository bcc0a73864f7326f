"""recurrentgemma-9b [hybrid]: 38L d4096 16H (MQA kv=1, head_dim 256)
d_ff=12288, vocab 256000, lru_width 4096, local attention window 2048 —
pattern (RG-LRU, RG-LRU, local-attn), 38 = 12 cycles of 3 + 2 tail (R,R).
[arXiv:2402.19427]  (The reference's `repro.configs.recurrentgemma_9b`,
field for field.)"""
import dataclasses

from ..models.config import ModelConfig

_PAT = (("rglru", "swiglu"), ("rglru", "swiglu"), ("local", "swiglu"))
CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", num_layers=38, d_model=4096,
    num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
    vocab_size=256000, pattern=_PAT, local_window=2048, lru_width=4096)

SMOKE = dataclasses.replace(
    CONFIG, name="recurrentgemma-smoke", num_layers=8, d_model=64,
    num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
    local_window=8, lru_width=64, attn_impl="dense")
