"""Architecture registry of the port: `get_config(arch_id)`.

The port of `repro.configs`.  Each module defines CONFIG (full size) and
SMOKE (reduced, same family), field for field the reference's: the dense
LMs `paper_edge` (the paper's MobileNet-ladder analogue), `gemma3_1b`,
`internlm2_20b`, `deepseek_coder_33b` and `h2o_danube_1_8b` (sliding
window), the MoE LMs `granite_moe_1b_a400m` and `granite_moe_3b_a800m`,
the SSM `mamba2_130m`, the hybrid `recurrentgemma_9b` (RG-LRU and local
attention), the encoder-decoder `whisper_base` and the VLM
`internvl2_76b` (patch embeddings, a float8 KV cache).
"""
from __future__ import annotations

import importlib
from typing import List

ARCHS: List[str] = [
    "granite_moe_3b_a800m",
    "granite_moe_1b_a400m",
    "internlm2_20b",
    "deepseek_coder_33b",
    "h2o_danube_1_8b",
    "gemma3_1b",
    "internvl2_76b",
    "whisper_base",
    "recurrentgemma_9b",
    "mamba2_130m",
    "paper_edge",          # the paper's own MobileNet-ladder analogue
]


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = canon(arch)
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; known: {ARCHS}")
    return importlib.import_module(f"{__name__}.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


def all_archs() -> List[str]:
    return [a for a in ARCHS if a != "paper_edge"]
