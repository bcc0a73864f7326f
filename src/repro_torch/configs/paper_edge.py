"""The paper's own setting transplanted: a MobileNet-alpha-style ladder of
LM variants for the ED tier plus the full model for the ES tier (the
reference's `repro.configs.paper_edge`, field for field).  Used by
`repro_torch.launch.serve`."""
import dataclasses

from ..models.config import dense_lm

# "ResNet50 on the server" analogue: the full model
CONFIG = dense_lm("paper-edge-es", layers=8, d_model=512, heads=8,
                  kv_heads=4, d_ff=1536, vocab=2048)

# "MobileNet alpha ladder" analogue: ED-tier variants
ED_VARIANTS = (
    CONFIG.scaled(0.25),
    CONFIG.scaled(0.5),
)

SMOKE = dataclasses.replace(
    CONFIG, name="paper-edge-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, attn_impl="dense")
