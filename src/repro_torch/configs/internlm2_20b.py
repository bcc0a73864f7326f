"""internlm2-20b [dense]: 48L d6144 48H (GQA kv=8) d_ff=16384,
vocab 92544. [arXiv:2403.17297]  (The reference's
`repro.configs.internlm2_20b`, field for field.)"""
import dataclasses

from ..models.config import dense_lm

CONFIG = dense_lm("internlm2-20b", layers=48, d_model=6144, heads=48,
                  kv_heads=8, d_ff=16384, vocab=92544)

SMOKE = dataclasses.replace(
    CONFIG, name="internlm2-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, attn_impl="dense")
