"""Tier latency/accuracy profiles (port of the analytic half of
`repro.serving.profile`: `TierProfile`, `comm_time`, `roofline_profile`).

The reference's ES defaults are TPU v5e constants; here the ES tier's peak
FLOP/s and memory bytes/s are required arguments with no default, so a
caller states which server silicon it models.  Wall-clock profiling
(`measure_profiles`) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.types import OffloadInstance


@dataclasses.dataclass
class TierProfile:
    """p_ij generator: per-model seconds for each job size-class."""
    name: str
    p_ed: np.ndarray              # (n_class, m) ED-model seconds
    p_es: np.ndarray              # (n_class,) total ES seconds (comm incl.)
    acc: np.ndarray               # (m+1,)
    classes: Sequence[int]        # size-class labels (e.g. image dims)

    def instance(self, job_classes: np.ndarray, T: float) -> OffloadInstance:
        ci = np.searchsorted(np.asarray(self.classes), job_classes)
        return OffloadInstance(p_ed=self.p_ed[ci], p_es=self.p_es[ci],
                               acc=self.acc.copy(), T=T)


def comm_time(payload_bytes: float, link_gbps: float = 50.0) -> float:
    """The paper's c_j: payload bytes over the link."""
    return payload_bytes / (link_gbps * 1e9)


def roofline_profile(name: str, classes: Sequence[int], *,
                     flops_per_class: Sequence[float],
                     bytes_per_class: Sequence[float],
                     model_scales: Sequence[float],
                     acc: Sequence[float],
                     payload_bytes: Sequence[float],
                     es_peak_flops: float,
                     es_hbm_bw: float,
                     ed_peak_flops: float = 2e12,
                     ed_hbm_bw: float = 60e9,
                     link_gbps: float = 50.0) -> TierProfile:
    """Analytic TierProfile from roofline terms: a request's step time on a
    tier is the max of its compute and memory terms.  The ED ladder holds
    width-scaled variants of the full model (`model_scales`, ascending);
    the ES tier runs the full model at ``es_peak_flops`` / ``es_hbm_bw``;
    offloading adds the payload over the link."""
    f = np.asarray(flops_per_class, np.float64)
    by = np.asarray(bytes_per_class, np.float64)
    scales = np.asarray(model_scales, np.float64)
    if len(f) != len(classes) or len(by) != len(classes):
        raise ValueError("per-class terms must match `classes`")
    if len(acc) != len(scales) + 1:
        raise ValueError("acc must have one entry per ED model plus the ES")
    # width scaling: flops ~ scale^2, activation bytes ~ scale
    p_ed = np.maximum(f[:, None] * scales[None, :] ** 2 / ed_peak_flops,
                      by[:, None] * scales[None, :] / ed_hbm_bw)
    es_step = np.maximum(f / es_peak_flops, by / es_hbm_bw)
    comm = np.array([comm_time(p, link_gbps) for p in payload_bytes])
    return TierProfile(name=name, p_ed=p_ed, p_es=es_step + comm,
                       acc=np.asarray(acc, np.float64), classes=list(classes))
