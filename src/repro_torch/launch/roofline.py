"""Roofline terms of a dry-run cell on one NVIDIA H100 SXM (the port of
`repro.launch.roofline`; counts per rank come from `launch.op_cost`).

Hardware constants (NVIDIA H100 SXM 80 GB data sheet, dense rates,
700 W):
  989 TFLOP/s bf16 | 3.35 TB/s HBM3 | 450 GB/s NVLink 4 a direction.

Terms (seconds; per-rank quantities):
  compute    = flops_per_chip / peak
  memory     = bytes_accessed_per_chip / hbm_bw
  collective = collective_bytes_per_chip / link_bw

MODEL_FLOPS (analytic "useful" flops, global):
  train_4k    : 6 * N_active * tokens
  prefill_32k : 2 * N_active * tokens
  decode      : 2 * N_active * batch  (+ KV-cache reads are memory, not flops)
with N_active = active params excluding embed/unembed tables.
"""
from __future__ import annotations

from typing import Any, Dict

PEAK_FLOPS = 989e12       # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12          # B/s, HBM3, H100 SXM data sheet
LINK_BW = 450e9           # B/s a direction, NVLink 4, H100 SXM data sheet


def terms(flops_per_chip: float, bytes_per_chip: float,
          coll_bytes_per_chip: float) -> Dict[str, float]:
    compute = flops_per_chip / PEAK_FLOPS
    memory = bytes_per_chip / HBM_BW
    coll = coll_bytes_per_chip / LINK_BW
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", coll), key=lambda kv: kv[1])[0]
    step = max(compute, memory, coll)
    return {
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "dominant": dominant, "step_lower_bound_s": step,
        # the share of the step at peak flops if the dominant term hid the
        # others entirely
        "roofline_fraction": compute / step if step > 0 else 0.0,
    }


def model_flops(cfg, shape_info: Dict[str, Any]) -> float:
    emb = 2 * cfg.padded_vocab * cfg.d_model
    n_active = cfg.active_param_count() - emb
    B, S = shape_info["batch"], shape_info["seq"]
    kind = shape_info["kind"]
    if kind == "train":
        return 6.0 * n_active * B * S
    if kind == "prefill":
        return 2.0 * n_active * B * S
    return 2.0 * n_active * B          # decode: one token per sequence
