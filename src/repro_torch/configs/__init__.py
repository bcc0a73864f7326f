"""Architecture registry of the port: `get_config(arch_id)`.

The port of `repro.configs`.  Each ported module defines CONFIG (full
size) and SMOKE (reduced, same family), field for field the reference's.
Ported so far: the dense LMs the serving path runs, `paper_edge` (the
paper's MobileNet-ladder analogue) and `gemma3_1b`, the SSM
`mamba2_130m` and the hybrid `recurrentgemma_9b` (RG-LRU and local
attention).  Asking for another architecture of the reference raises
`NotImplementedError` naming the ROADMAP item that ports it.
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

PORTED = ("gemma3_1b", "paper_edge", "mamba2_130m", "recurrentgemma_9b")

_ITEM = "ROADMAP §1 item 12"
_NOT_PORTED = {
    "granite_moe_3b_a800m": f"{_ITEM}: moe",
    "granite_moe_1b_a400m": f"{_ITEM}: moe",
    "whisper_base": f"{_ITEM}: enc-dec",
    "internvl2_76b": f"{_ITEM}: vlm",
    "internlm2_20b": f"{_ITEM}: the remaining dense configs",
    "deepseek_coder_33b": f"{_ITEM}: the remaining dense configs",
    "h2o_danube_1_8b": f"{_ITEM}: the remaining dense configs",
}


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = canon(arch)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet ({_NOT_PORTED[name]})")
    if name not in PORTED:
        raise ValueError(f"unknown architecture {arch!r}; known: {ARCHS}")
    return importlib.import_module(f"{__name__}.{name}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE

