"""deepseek-coder-33b [dense]: 62L d7168 56H (GQA kv=8) d_ff=19200,
vocab 32256 — llama-arch. [arXiv:2401.14196]  (The reference's
`repro.configs.deepseek_coder_33b`, field for field.)"""
import dataclasses

from ..models.config import dense_lm

CONFIG = dense_lm("deepseek-coder-33b", layers=62, d_model=7168, heads=56,
                  kv_heads=8, d_ff=19200, vocab=32256)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-coder-smoke", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    attn_impl="dense")
