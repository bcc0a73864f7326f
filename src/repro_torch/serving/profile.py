"""Tier latency/accuracy profiles (port of `repro.serving.profile`:
`TierProfile`, `measure_latency`, `measure_profiles`, `comm_time`,
`roofline_profile`).

Two sources of p_ij, as in the reference: wall-clock medians of apply
functions (`measure_profiles`, the paper's methodology, §VII-B) and
analytic roofline terms (`roofline_profile`).  A measured call waits for
the card (`torch.cuda.synchronize`) when its output holds CUDA tensors,
so a latency is the work's time and not its launch time.  The reference's
ES defaults of `roofline_profile` are TPU v5e constants; here the ES
tier's peak FLOP/s and memory bytes/s are required arguments with no
default, so a caller states which server silicon it models.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch

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


def _holds_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return any(_holds_cuda(v) for v in x)
    return False


def _block(x) -> None:
    """Wait for the card when ``x`` holds CUDA tensors (the reference's
    `jax.block_until_ready`)."""
    if _holds_cuda(x):
        torch.cuda.synchronize()


def measure_latency(fn: Callable, args, iters: int = 30) -> float:
    """Median wall seconds of ``fn(*args)`` over ``iters`` calls, after
    one warm-up call."""
    fn(*args)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _block(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def measure_profiles(apply_fns: Dict[str, Callable], sample_batches,
                     accs: Dict[str, float], es_name: str,
                     comm_seconds: Sequence[float], classes: Sequence[int],
                     iters: int = 30) -> TierProfile:
    """apply_fns: model name -> fn(batch); ``es_name`` names the ES-tier
    model.  ``comm_seconds``: per size-class upload time.  The ED models
    are ordered by accuracy, as the planner expects."""
    ed_names = [n for n in apply_fns if n != es_name]
    p_ed = np.zeros((len(classes), len(ed_names)))
    p_es = np.zeros(len(classes))
    for c, batch in enumerate(sample_batches):
        for j, n in enumerate(ed_names):
            p_ed[c, j] = measure_latency(apply_fns[n], (batch,), iters)
        p_es[c] = comm_seconds[c] + measure_latency(
            apply_fns[es_name], (batch,), iters)
    acc = np.array([accs[n] for n in ed_names] + [accs[es_name]])
    order = np.argsort(acc[:-1])
    return TierProfile(name="measured", p_ed=p_ed[:, order],
                       p_es=p_es, acc=np.concatenate([acc[:-1][order],
                                                      acc[-1:]]),
                       classes=classes)


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
