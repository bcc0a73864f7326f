"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) d_ff=512/expert,
vocab 49155, 40 experts top-8. [hf:ibm-granite/granite-3.0-*-base; hf]
(The reference's `repro.configs.granite_moe_3b_a800m`, field for
field.)"""
import dataclasses

from ..models.config import moe_lm

CONFIG = moe_lm("granite-moe-3b-a800m", layers=32, d_model=1536, heads=24,
                kv_heads=8, d_ff_expert=512, vocab=49155, n_experts=40,
                top_k=8)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-moe-3b-smoke", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=256, num_experts=8,
    experts_per_token=2, moe_d_ff=32, attn_impl="dense")
