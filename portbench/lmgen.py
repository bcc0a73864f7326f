"""The language model's inputs, made from the seed on the card: the
parameters in the port's layout (one normal draw into one float32
buffer, then a scale per leaf), the port's model configuration built
from the configuration file, and the token pools."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from portbench import work


def model_config(cfg: Dict[str, Any]):
    """The port's `ModelConfig` for a configuration file (a MoE LM)."""
    from repro_torch.models.config import moe_lm
    return moe_lm(cfg["name"], layers=int(cfg["num_hidden_layers"]),
                  d_model=int(cfg["hidden_size"]),
                  heads=int(cfg["num_attention_heads"]),
                  kv_heads=int(cfg["num_key_value_heads"]),
                  d_ff_expert=int(cfg["intermediate_size"]),
                  vocab=int(cfg["vocab_size"]),
                  n_experts=int(cfg["num_local_experts"]),
                  top_k=int(cfg["num_experts_per_tok"]),
                  capacity_factor=float(cfg["capacity_factor"]),
                  moe_groups=int(cfg["moe_groups"]),
                  norm_eps=float(cfg["rms_norm_eps"]),
                  rope_theta=float(cfg["rope_theta"]),
                  dtype=cfg["dtype"], param_dtype=cfg["param_dtype"],
                  kv_cache_dtype=cfg["kv_cache_dtype"])


def leaves(cfg: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, scale) of every parameter: a normal draw times
    ``scale`` (1 / sqrt of the product's input width; 0 for the norms'
    scales, which multiply by 1 + scale)."""
    s = work.lm_dims(cfg)
    L, d, H, KH, Hd = s["L"], s["d"], s["H"], s["KH"], s["Hd"]
    E, F, V = s["E"], s["F"], s["V"]

    def r(n):
        return 1.0 / math.sqrt(n)
    return [("embed", (V, d), 1.0), ("unembed", (d, V), r(d)),
            ("final_norm", (d,), 0.0),
            ("fnorm", (L, d), 0.0), ("norm", (L, d), 0.0),
            ("router", (L, d, E), r(d)),
            ("we_down", (L, E, F, d), r(F)),
            ("we_gate", (L, E, d, F), r(d)), ("we_up", (L, E, d, F), r(d)),
            ("wk", (L, d, KH * Hd), r(d)), ("wo", (L, H * Hd, d), r(H * Hd)),
            ("wq", (L, d, H * Hd), r(d)), ("wv", (L, d, KH * Hd), r(d))]


def make_params(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """Parameters in the port's tree (``embed``, ``unembed``,
    ``final_norm``, ``blocks`` = one dict stacked over the layers, no
    ``tail``), float32, drawn on ``device`` from ``seed`` in one call."""
    spec = leaves(cfg)
    total = sum(math.prod(shape) for _n, shape, _s in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    buf.normal_(generator=gen)
    out, at = {}, 0
    for name, shape, scale in spec:
        n = math.prod(shape)
        leaf = buf[at:at + n].view(shape)
        leaf.mul_(scale)
        out[name] = leaf
        at += n
    top = ("embed", "unembed", "final_norm")
    return {**{k: out[k] for k in top},
            "blocks": ({k: v for k, v in out.items() if k not in top},),
            "tail": ()}


def token_pool(n: int, length: int, vocab: int, seed: int, device
               ) -> torch.Tensor:
    """(n, length) token ids drawn uniformly from the vocabulary."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, vocab, (n, length), generator=gen,
                         device=device)
