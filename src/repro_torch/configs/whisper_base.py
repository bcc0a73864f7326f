"""whisper-base [audio]: enc-dec, 6+6L d512 8H d_ff=2048, vocab 51865 —
the conv frontend is a stub: 1500 precomputed frame embeddings (B, 1500,
512) come in as ``batch["audio_feats"]``; encoder layers are non-causal
("enc"), decoder layers causal self-attention + cross-attention ("dec").
GELU FFNs; RoPE stands in for Whisper's learned positions (decoder side).
[arXiv:2212.04356]  (The reference's `repro.configs.whisper_base`, field
for field.)"""
import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio", num_layers=6, d_model=512,
    num_heads=8, num_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=51865,
    pattern=(("dec", "gelu"),), encoder_layers=6, encoder_seq=1500)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256, encoder_layers=2,
    encoder_seq=16, attn_impl="dense")
