"""Heterogeneous fleet construction (port of `DeviceSpec`,
`paper_style_profile`, `roofline_style_profile` and `make_fleet` from
`repro.serving.fleet`).

The NumPy draws happen in the reference's order, so with the same seed and
the same ES constants the port's fleet equals the reference's.  The ES
tier's peak FLOP/s and bytes/s have no default: the reference's defaults
are TPU v5e figures, and a caller of the port states its own.  The host
`FleetEngine` is not ported yet (ROADMAP §1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core.instances import (PAPER_ACC, PAPER_COMM, PAPER_P_ED,
                              PAPER_P_ES_PROC)
from .profile import TierProfile, roofline_profile


@dataclasses.dataclass
class DeviceSpec:
    """One edge device: its believed latency `profile`, the true per-period
    ED slowdown factors `drift` (cycled, 1.0 = nominal) and the periods
    its ES link is down (`outage`)."""
    profile: TierProfile
    drift: Optional[np.ndarray] = None
    outage: Optional[np.ndarray] = None
    name: str = ""

    def drift_at(self, period: int) -> float:
        if self.drift is None or len(self.drift) == 0:
            return 1.0
        return float(self.drift[period % len(self.drift)])

    def outage_at(self, period: int) -> bool:
        if self.outage is None or len(self.outage) == 0:
            return False
        return bool(self.outage[period % len(self.outage)])


def paper_style_profile(rng: np.random.Generator,
                        classes: Sequence[int] = (128, 512, 1024)
                        ) -> TierProfile:
    """The paper's Raspberry-Pi/ResNet50 testbed numbers with per-device
    jitter."""
    jit_ed = rng.uniform(0.8, 1.3, size=(len(classes), 2))
    jit_es = rng.uniform(0.9, 1.2, size=len(classes))
    p_ed = np.array([PAPER_P_ED[c] for c in classes]) * jit_ed
    p_es = np.array([PAPER_COMM[c] + PAPER_P_ES_PROC[c]
                     for c in classes]) * jit_es
    return TierProfile(name="paper-jittered", p_ed=p_ed, p_es=p_es,
                       acc=PAPER_ACC.copy(), classes=list(classes))


def roofline_style_profile(rng: np.random.Generator,
                           classes: Sequence[int] = (128, 512, 1024), *,
                           es_peak_flops: float, es_hbm_bw: float
                           ) -> TierProfile:
    """A roofline-derived device: LM-ladder latencies from analytic
    compute/memory terms, scaled to the paper's regime; the ES tier runs
    at ``es_peak_flops`` / ``es_hbm_bw``."""
    dims = np.asarray(classes, np.float64)
    flops = 4e9 * (dims / dims[0])                  # per-request useful flops
    acts = 6e7 * (dims / dims[0])                   # activation traffic bytes
    payload = 3.0 * dims ** 2                       # image-ish upload bytes
    derate = rng.uniform(0.7, 1.4)
    return roofline_profile(
        "roofline", list(classes),
        flops_per_class=flops, bytes_per_class=acts,
        model_scales=(0.25, 0.75), acc=(0.42, 0.58, 0.78),
        payload_bytes=payload,
        ed_peak_flops=1.2e12 * derate, ed_hbm_bw=40e9 * derate,
        es_peak_flops=es_peak_flops, es_hbm_bw=es_hbm_bw,
        link_gbps=0.08)


def make_fleet(n_devices: int, *, es_peak_flops: float, es_hbm_bw: float,
               classes: Sequence[int] = (128, 512, 1024),
               roofline_frac: float = 0.5, straggler_frac: float = 0.25,
               outage_frac: float = 0.1, drift_mag: float = 3.0,
               horizon: int = 64, seed: int = 0) -> List[DeviceSpec]:
    """A heterogeneous fleet mixing paper-style and roofline-derived
    devices, with `straggler_frac` of them drifting to `drift_mag x`
    slowdown partway through the horizon and `outage_frac` suffering
    ES-link outages.  ``es_peak_flops`` / ``es_hbm_bw`` describe the ES
    silicon of the roofline-derived devices."""
    rng = np.random.default_rng(seed)
    specs: List[DeviceSpec] = []
    for d in range(n_devices):
        if rng.uniform() < roofline_frac:
            prof = roofline_style_profile(rng, classes,
                                          es_peak_flops=es_peak_flops,
                                          es_hbm_bw=es_hbm_bw)
        else:
            prof = paper_style_profile(rng, classes)
        drift = None
        if rng.uniform() < straggler_frac:
            onset = rng.integers(1, max(2, horizon // 2))
            drift = np.ones(horizon)
            drift[onset:] = drift_mag
        outage = None
        if rng.uniform() < outage_frac:
            outage = rng.uniform(size=horizon) < 0.2
        specs.append(DeviceSpec(profile=prof, drift=drift, outage=outage,
                                name=f"dev{d}"))
    return specs
