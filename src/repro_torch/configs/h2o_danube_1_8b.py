"""h2o-danube-1.8b [dense]: 24L d2560 32H (GQA kv=8) d_ff=6912, vocab 32000
— llama+mistral mix, sliding-window attention (W=4096) on every layer.
[arXiv:2401.16818]  (The reference's `repro.configs.h2o_danube_1_8b`,
field for field.)"""
import dataclasses

from ..models.config import dense_lm

CONFIG = dense_lm("h2o-danube-1.8b", layers=24, d_model=2560, heads=32,
                  kv_heads=8, d_ff=6912, vocab=32000, mixer="swa",
                  window_size=4096)

SMOKE = dataclasses.replace(
    CONFIG, name="h2o-danube-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, window_size=8,
    attn_impl="dense")
