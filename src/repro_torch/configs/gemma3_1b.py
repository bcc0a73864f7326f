"""gemma3-1b [dense]: 26L d1152 4H (GQA kv=1, head_dim 256) d_ff=6912,
vocab 262144 — 5:1 local(512):global pattern, 128k-class context.
[hf:google/gemma-3-1b-pt]  (The reference's `repro.configs.gemma3_1b`,
field for field.)

26 = 4 cycles of (L,L,L,L,L,G) + 2 tail local layers."""
import dataclasses

from ..models.config import ModelConfig

_PAT = (("local", "swiglu"),) * 5 + (("global", "swiglu"),)
CONFIG = ModelConfig(
    name="gemma3-1b", family="dense", num_layers=26, d_model=1152,
    num_heads=4, num_kv_heads=1, head_dim=256, d_ff=6912, vocab_size=262144,
    pattern=_PAT, local_window=512, rope_theta=10_000.0,
    rope_theta_global=1_000_000.0)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-smoke", num_layers=14, d_model=64, num_heads=4,
    num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512, local_window=8,
    attn_impl="dense")
