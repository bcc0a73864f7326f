"""Adafactor (Shazeer & Stern, 2018) — factored second moments: the port
of `repro.optim.adafactor`.

A leaf of two or more dimensions keeps its second moment as row and
column means over its last two axes (so a stacked leaf (cycles, d_in,
d_out) factors per cycle, as in the reference); a vector keeps the full
second moment and a dummy scalar column.  No first moment; the update is
clipped by its RMS.  Trees and numerics as in `adamw`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import _tree
from .adamw import _device_of, _lr_at

PyTree = Any


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: PyTree      # row second moments   (or full v for <2-D params)
    vc: PyTree      # column second moments (dummy scalar for <2-D)


def _factored(shape) -> bool:
    return len(shape) >= 2


@torch.no_grad()
def adafactor_init(params: PyTree) -> AdafactorState:
    def vr_like(p):
        shape = p.shape[:-1] if _factored(p.shape) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc_like(p):
        shape = (p.shape[:-2] + p.shape[-1:] if _factored(p.shape)
                 else ())
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return AdafactorState(step=torch.zeros((), dtype=torch.int32,
                                           device=_device_of(params)),
                          vr=_tree.tree_map(vr_like, params),
                          vc=_tree.tree_map(vc_like, params))


@torch.no_grad()
def adafactor_update(grads: PyTree, state: AdafactorState, params: PyTree,
                     *, lr, decay: float = 0.8, eps: float = 1e-30,
                     clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    """Returns ``(new_params, new_state)``; the second moments decay by
    beta = 1 - step^-decay."""
    step = state.step + 1
    lr_t = _lr_at(lr, step)
    beta = 1.0 - step.float() ** (-decay)

    def upd(p, g, vr, vc):
        g = g.float()
        g2 = g * g + eps
        if _factored(p.shape):
            vr2 = beta * vr + (1 - beta) * g2.mean(dim=-1)
            vc2 = beta * vc + (1 - beta) * g2.mean(dim=-2)
            r = vr2 / torch.clamp(vr2.mean(dim=-1, keepdim=True), min=eps)
            u = g / (torch.sqrt(r)[..., None]
                     * torch.sqrt(vc2)[..., None, :] + eps)
        else:
            vr2 = beta * vr + (1 - beta) * g2
            vc2 = vc
            u = g / (torch.sqrt(vr2) + eps)
        rms_u = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        p2 = p.float() - lr_t * (u + weight_decay * p.float())
        return p2.to(p.dtype), vr2, vc2

    flat_p, treedef = _tree.flatten(params)
    out = [upd(*xs) for xs in zip(flat_p, _tree.leaves(grads),
                                  _tree.leaves(state.vr),
                                  _tree.leaves(state.vc))]
    new_p, new_vr, new_vc = _tree.transpose(treedef, 3, out)
    return new_p, AdafactorState(step=step, vr=new_vr, vc=new_vc)
