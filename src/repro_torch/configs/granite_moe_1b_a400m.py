"""granite-moe-1b-a400m [moe]: 24L d1024 16H (GQA kv=8) d_ff=512/expert,
vocab 49155, 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]
(The reference's `repro.configs.granite_moe_1b_a400m`, field for
field.)"""
import dataclasses

from ..models.config import moe_lm

CONFIG = moe_lm("granite-moe-1b-a400m", layers=24, d_model=1024, heads=16,
                kv_heads=8, d_ff_expert=512, vocab=49155, n_experts=32,
                top_k=8)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-moe-1b-smoke", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, vocab_size=256, num_experts=4,
    experts_per_token=2, moe_d_ff=32, attn_impl="dense")
