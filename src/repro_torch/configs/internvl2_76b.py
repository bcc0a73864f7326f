"""internvl2-76b [vlm]: 80L d8192 64H (GQA kv=8) d_ff=28672, vocab 128256 —
InternViT + LLM backbone.  The ViT frontend is a stub: 256 precomputed
patch embeddings (``batch["patch_embeds"]``) replace the first 256 token
positions.  The KV cache is float8_e4m3fn.  [arXiv:2404.16821]  (The
reference's `repro.configs.internvl2_76b`, field for field.)"""
import dataclasses

from ..models.config import dense_lm

CONFIG = dataclasses.replace(
    dense_lm("internvl2-76b", layers=80, d_model=8192, heads=64, kv_heads=8,
             d_ff=28672, vocab=128256),
    num_patches=256)
CONFIG = dataclasses.replace(CONFIG, family="vlm",
                             kv_cache_dtype="float8_e4m3fn")

SMOKE = dataclasses.replace(
    CONFIG, name="internvl2-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, num_patches=4,
    attn_impl="dense")
