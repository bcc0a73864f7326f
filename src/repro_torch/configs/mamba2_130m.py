"""mamba2-130m [ssm]: 24L d768 attn-free, SSD (state-space duality),
d_state=128, expand=2 (d_inner 1536), headdim 64 -> 24 ssm heads,
vocab 50280. [arXiv:2405.21060]  (The reference's
`repro.configs.mamba2_130m`, field for field.)"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
    num_heads=1, num_kv_heads=1, head_dim=64, d_ff=0, vocab_size=50280,
    pattern=(("ssd", "none"),), ssm_state=128, ssm_heads=24,
    ssm_head_dim=64, ssm_expand=2, conv_width=4, ssm_chunk=256)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", num_layers=2, d_model=64, vocab_size=256,
    ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=8)
