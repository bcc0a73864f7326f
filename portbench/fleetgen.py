"""The fleet's inputs, made from the seed: a vectorised copy of the port's
`serving.fleet.make_fleet` (paper-style and roofline-derived device
profiles, stragglers, outages) and of `serving.queue.RequestQueue`'s
replay semantics (Poisson counts per device and period, i.i.d. job
classes, uniform, in arrival order, at most ``batch_max`` released a
period).

The draws are the same distributions as the port's, drawn in bulk with
one NumPy generator, not device by device, so they are not the port's
numbers for the same seed.  The result is the arrays that
`api.engine.params_from_arrays` and `state_from_arrays` take; the
reference reads the same arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

# the paper's testbed (§VII, Tables I/II): ED latencies of the two local
# models, ES processing and LAN communication per image dimension, and
# the accuracies of MobileNet .25 / .75 and ResNet50
PAPER_ACC = (0.395, 0.559, 0.771)
PAPER_P_ED = {128: (0.010, 0.040), 512: (0.011, 0.040), 1024: (0.011, 0.043)}
PAPER_P_ES_PROC = {128: 0.28, 512: 0.32, 1024: 0.38}
PAPER_COMM = {128: 0.07, 512: 0.23, 1024: 0.70}
# roofline-derived devices: an LM ladder at two widths, the ES tier at
# the configuration's peak rates, the payload over a 0.08 Gb/s link
ROOF_ACC = (0.42, 0.58, 0.78)
ROOF_SCALES = (0.25, 0.75)


def _paper_tables(classes, n, rng):
    jit_ed = rng.uniform(0.8, 1.3, size=(n, len(classes), 2))
    jit_es = rng.uniform(0.9, 1.2, size=(n, len(classes)))
    p_ed = np.array([PAPER_P_ED[c] for c in classes])[None] * jit_ed
    p_es = np.array([PAPER_COMM[c] + PAPER_P_ES_PROC[c]
                     for c in classes])[None] * jit_es
    return p_ed, p_es


def _roofline_tables(classes, n, rng, es_peak_flops, es_hbm_bw):
    dims = np.asarray(classes, np.float64)
    flops = 4e9 * (dims / dims[0])
    acts = 6e7 * (dims / dims[0])
    payload = 3.0 * dims ** 2
    derate = rng.uniform(0.7, 1.4, size=n)[:, None, None]
    s = np.asarray(ROOF_SCALES)[None, None, :]
    p_ed = np.maximum(flops[None, :, None] * s ** 2 / (1.2e12 * derate),
                      acts[None, :, None] * s / (40e9 * derate))
    es_step = np.maximum(flops / es_peak_flops, acts / es_hbm_bw)
    comm = payload / (0.08 * 1e9)
    p_es = np.broadcast_to(es_step + comm, (n, len(classes))).copy()
    return p_ed, p_es


def make_arrays(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int
                ) -> Dict[str, np.ndarray]:
    """The engine's parameter arrays for ``cfg`` (a fleet configuration)
    under ``traffic`` (its arrivals), from ``seed``: ``base_p_ed`` (D, c,
    m), ``p_es`` (D, c), ``acc`` (D, m + 1), ``T``, ``rate`` (D,),
    ``class_probs`` (c,), ``drift`` and ``outage`` (D, H), ``counts`` (H,
    D) and ``stream`` (D, S)."""
    rng = np.random.default_rng(seed)
    D, H = int(cfg["n_devices"]), int(cfg["horizon"])
    classes = tuple(cfg["classes"])
    c = len(classes)
    roof = rng.uniform(size=D) < cfg["roofline_frac"]
    n_roof = int(roof.sum())
    p_ed = np.empty((D, c, 2))
    p_es = np.empty((D, c))
    acc = np.empty((D, 3))
    p_ed[~roof], p_es[~roof] = _paper_tables(classes, D - n_roof, rng)
    p_ed[roof], p_es[roof] = _roofline_tables(
        classes, n_roof, rng, cfg["es_peak_flops"], cfg["es_hbm_bw"])
    acc[~roof] = PAPER_ACC
    acc[roof] = ROOF_ACC
    # stragglers slow to drift_mag from an onset in [1, H/2); outages hit
    # a fraction of the devices, each period with probability outage_prob
    drift = np.ones((D, H))
    strag = rng.uniform(size=D) < cfg["straggler_frac"]
    onset = rng.integers(1, max(2, H // 2), size=D)
    drift[strag[:, None] & (np.arange(H)[None, :] >= onset[:, None])] = \
        cfg["drift_mag"]
    down = rng.uniform(size=D) < cfg["outage_frac"]
    outage = down[:, None] & (rng.uniform(size=(D, H)) < cfg["outage_prob"])
    probs = np.full(c, 1.0 / c)
    rate = np.full(D, float(traffic["rate"]))
    counts = rng.poisson(rate[None, :], size=(H, D))
    S = max(int(counts.sum(axis=0).max()), 1)
    stream = rng.choice(c, size=(D, S), p=probs).astype(np.int32)
    return dict(base_p_ed=p_ed, p_es=p_es, acc=acc, T=float(cfg["T"]),
                rate=rate, class_probs=probs, drift=drift, outage=outage,
                counts=counts.astype(np.int32), stream=stream)


def initial_state(arrays: Dict[str, np.ndarray], batch_max: int
                  ) -> Dict[str, np.ndarray]:
    """A fresh fleet for `state_from_arrays`: beliefs = profiles, no
    backlog, cold bases (R = batch_max + 2 labels of -1), one cell."""
    D = arrays["base_p_ed"].shape[0]
    return dict(period=np.int32(0), p_ed=arrays["base_p_ed"],
                pending=np.zeros(D, np.int32), head=np.zeros(D, np.int32),
                warm_basis=np.full((D, batch_max + 2), -1, np.int32),
                n_updates=np.zeros(D, np.int32), pos=np.zeros((D, 2)),
                cell=np.zeros(D, np.int32), cell_load=np.zeros(1),
                p_es_belief=arrays["p_es"], seed=np.int64(0))


def fault_trace(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int
                ) -> Dict[str, np.ndarray]:
    """A fault draw for every period of the horizon (the port's
    `core.faults.sample_realization` distribution, drawn in bulk here):
    ``es_crash`` (H,), ``link_factor`` and ``straggler_factor`` (H, D),
    ``lost`` (H, D, batch_max, max_retries + 1)."""
    fm = traffic["faults"]
    rng = np.random.default_rng(seed)
    D, H = int(cfg["n_devices"]), int(cfg["horizon"])
    A = int(traffic["max_retries"]) + 1
    u = rng.uniform(size=(3, H, D))
    link = np.where(u[0] < fm["link_degrade_prob"],
                    1.0 + fm["link_degrade_mag"] * u[1], 1.0)
    strag = np.where(u[2] < fm["straggler_prob"], fm["straggler_mult"], 1.0)
    crash = rng.uniform(size=H) < fm["es_crash_prob"]
    lost = rng.random(size=(H, D, int(cfg["batch_max"]), A),
                      dtype=np.float32) < fm["loss_rate"]
    return dict(es_crash=crash, link_factor=link, straggler_factor=strag,
                lost=lost)
