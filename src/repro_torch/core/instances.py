"""Problem-instance generators (port of `repro.core.instances`).

`paper_instance` reproduces the paper's testbed numbers (§VII, Tables I/II,
Fig. 2): Raspberry-Pi MobileNets (alpha = 0.25 / 0.75) + server ResNet50,
ImageNet images of dimension 128/512/1024 with LAN communication times.
The generators draw from the same NumPy streams as the reference, so one
seed gives the same instance on both sides.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .types import OffloadInstance

# --- paper constants (Tables I & II, Fig. 2) ------------------------------
PAPER_ACC = np.array([0.395, 0.559, 0.771])   # MobileNet .25 / .75, ResNet50
PAPER_DIMS = (128, 512, 1024)
# processing time (s) per image dimension
PAPER_P_ED = {128: (0.010, 0.040), 512: (0.011, 0.040), 1024: (0.011, 0.043)}
PAPER_P_ES_PROC = {128: 0.28, 512: 0.32, 1024: 0.38}
# communication + server-side reshape time (s), read off Fig. 2
PAPER_COMM = {128: 0.07, 512: 0.23, 1024: 0.70}


def paper_instance(n: int, T: float, seed: int = 0,
                   dims: Sequence[int] = PAPER_DIMS,
                   dim_probs: Optional[Sequence[float]] = None
                   ) -> OffloadInstance:
    """n ImageNet-style jobs with sizes sampled from `dims`."""
    rng = np.random.default_rng(seed)
    sizes = rng.choice(dims, size=n, p=dim_probs)
    p_ed = np.array([PAPER_P_ED[s] for s in sizes])
    p_es = np.array([PAPER_COMM[s] + PAPER_P_ES_PROC[s] for s in sizes])
    return OffloadInstance(p_ed=p_ed, p_es=p_es, acc=PAPER_ACC.copy(), T=T)


def random_instance(n: int, m: int, T: float, seed: int = 0, *,
                    p_lo: float = 1e-3, p_hi: float = 1.0,
                    es_speedup: float = 4.0, comm_lo: float = 0.01,
                    comm_hi: float = 0.5) -> OffloadInstance:
    """Random instance with accuracy increasing in model size (paper's
    monotone a_1 <= ... <= a_{m+1} convention)."""
    rng = np.random.default_rng(seed)
    base = np.sort(np.exp(rng.uniform(np.log(p_lo), np.log(p_hi), size=m)))
    jitter = np.exp(rng.normal(0.0, 0.15, size=(n, m)))
    p_ed = base[None, :] * jitter
    p_ed = np.sort(p_ed, axis=1)  # keep per-job monotonicity in model index
    es_proc = base[-1] / es_speedup * np.exp(rng.normal(0.0, 0.1, size=n))
    comm = rng.uniform(comm_lo, comm_hi, size=n)
    acc = np.sort(rng.uniform(0.3, 0.99, size=m + 1))
    return OffloadInstance(p_ed=p_ed, p_es=es_proc + comm, acc=acc, T=T)


def identical_instance(n: int, m: int, T: float, seed: int = 0
                       ) -> OffloadInstance:
    """n identical jobs (the paper's §VI setting)."""
    rng = np.random.default_rng(seed)
    base = np.sort(np.exp(rng.uniform(np.log(5e-3), np.log(0.5), size=m)))
    p_es = base[-1] / 3.0 + rng.uniform(0.05, 0.3)
    acc = np.sort(rng.uniform(0.3, 0.99, size=m + 1))
    return OffloadInstance(p_ed=np.tile(base, (n, 1)),
                           p_es=np.full(n, p_es), acc=acc, T=T)
