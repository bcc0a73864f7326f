"""Model configuration of the port: a copy of `repro.models.config`.

A model is a stack of layers described by a repeating ``pattern`` of
(mixer, ffn) pairs; ``num_layers = n_cycles * len(pattern) + tail``, the
tail layers being the pattern's prefix.  The port's `forward` loops over
the cycles and then the tail.  Every field, default and helper equals the
reference's, so a configuration means the same model in both packages;
fields the port does not read yet (MoE, SSM, RG-LRU, encoder, patches,
sharding and training knobs) are kept for that reason.

mixer kinds : full | swa | local | global | enc | dec | rglru | ssd
ffn kinds   : swiglu | gelu | moe | none
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

Layer = Tuple[str, str]  # (mixer, ffn)


def pad_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[Layer, ...]        # repeating per-layer (mixer, ffn)

    # attention
    window_size: int = 4096           # for "swa"
    local_window: int = 512           # for "local"
    rope_theta: float = 10_000.0
    rope_theta_global: float = 1_000_000.0

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 32              # dispatch groups (aligned with DP)

    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256

    # rg-lru (recurrentgemma)
    lru_width: int = 0

    # encoder-decoder (whisper): encoder layers use pattern ("enc","gelu")
    encoder_layers: int = 0
    encoder_seq: int = 0              # precomputed frame embeddings (stub)

    # vlm stub frontend
    num_patches: int = 0              # precomputed patch embeddings (stub)

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"  # fp8 halves cache HBM + read bw
    score_dtype: str = "float32"      # attention score emit dtype
    attn_impl: str = "auto"           # auto | dense | chunked | pallas
    attn_chunk: int = 512
    q_block: int = 0                  # >0: causal q-block chunking (structural
                                      # flop halving; see EXPERIMENTS §Perf)
    remat: str = "none"               # none | full | dots
    logit_chunk: int = 0              # >0: sequence-chunked loss
    microbatches: int = 1             # grad-accumulation steps per batch

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:         # ssd inner width
        return self.ssm_expand * self.d_model

    @property
    def cycles_and_tail(self) -> Tuple[int, int]:
        p = len(self.pattern)
        return self.num_layers // p, self.num_layers % p

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def scaled(self, width_mult: float, depth_mult: float = 1.0
               ) -> "ModelConfig":
        """MobileNet-alpha-style variant ladder (paper §III-A: the m ED
        models are instantiations of the same DNN at different sizes)."""
        def r128(x):
            return max(128, int(x * width_mult) // 128 * 128)

        p = len(self.pattern)
        nl = max(p, int(self.num_layers * depth_mult) // p * p)
        return dataclasses.replace(
            self, name=f"{self.name}-w{width_mult:g}",
            num_layers=nl,
            d_model=r128(self.d_model),
            d_ff=r128(self.d_ff) if self.d_ff else 0,
            moe_d_ff=r128(self.moe_d_ff) if self.moe_d_ff else 0,
            lru_width=r128(self.lru_width) if self.lru_width else 0,
            num_heads=max(1, int(self.num_heads * width_mult)),
            num_kv_heads=max(1, min(self.num_kv_heads,
                                    int(self.num_heads * width_mult))),
        )

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once; see
        the reference's benchmarks/roofline.py MODEL_FLOPS)."""
        d = self.d_model
        n = self.padded_vocab * d                       # embed
        n += self.padded_vocab * d                      # unembed (untied)
        enc = self.encoder_layers
        for li in range(self.num_layers + enc):
            mixer, ffn = self.layer_kind(li)
            if mixer in ("full", "swa", "local", "enc", "dec"):
                n += d * self.num_heads * self.head_dim * 2      # q, o
                n += d * self.num_kv_heads * self.head_dim * 2   # k, v
                if mixer == "dec":
                    n += d * self.num_heads * self.head_dim * 2
                    n += d * self.num_kv_heads * self.head_dim * 2
            elif mixer == "rglru":
                w = self.lru_width
                n += d * w * 2 + w * d + 3 * w           # in x2, out, gates
                n += w * self.conv_width
            elif mixer == "ssd":
                di = self.d_inner
                n += d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                n += di * d + di * self.conv_width + 2 * self.ssm_heads
            if ffn in ("swiglu",):
                n += 3 * d * self.d_ff
            elif ffn == "gelu":
                n += 2 * d * self.d_ff
            elif ffn == "moe":
                n += d * self.num_experts
                n += self.num_experts * 3 * d * self.moe_d_ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        dead = (self.num_experts - self.experts_per_token) * \
            3 * self.d_model * self.moe_d_ff * self.num_layers
        return full - dead

    def layer_kind(self, li: int) -> Layer:
        """(mixer, ffn) of decoder layer li (encoder layers are all enc)."""
        if li >= self.num_layers:  # encoder layers appended after decoder
            return ("enc", "gelu")
        return self.pattern[li % len(self.pattern)]


# ---------------------------------------------------------------------------
# family constructors
# ---------------------------------------------------------------------------
def dense_lm(name, layers, d_model, heads, kv_heads, d_ff, vocab, *,
             head_dim=None, mixer="full", **kw) -> ModelConfig:
    return ModelConfig(
        name=name, family=kw.pop("family", "dense"), num_layers=layers,
        d_model=d_model, num_heads=heads, num_kv_heads=kv_heads,
        head_dim=head_dim or d_model // heads, d_ff=d_ff, vocab_size=vocab,
        pattern=((mixer, "swiglu"),), **kw)


def moe_lm(name, layers, d_model, heads, kv_heads, d_ff_expert, vocab,
           n_experts, top_k, **kw) -> ModelConfig:
    return ModelConfig(
        name=name, family="moe", num_layers=layers, d_model=d_model,
        num_heads=heads, num_kv_heads=kv_heads, head_dim=d_model // heads,
        d_ff=0, vocab_size=vocab, pattern=(("full", "moe"),),
        num_experts=n_experts, experts_per_token=top_k,
        moe_d_ff=d_ff_expert, **kw)
