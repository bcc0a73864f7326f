"""AdamW (decoupled weight decay) over the port's parameter trees: the port
of `repro.optim.adamw`.

The trees are the layout `convert.model_params_from_numpy` and
`models.init_params` produce (dicts and tuples of tensors); the
functions walk them in `jax.tree_util`'s order (`_tree`), so the global
norm sums its leaves in the reference's order.  Moments are float32,
the update is computed in float32 and the parameters cast back to their
dtype; scalars that JAX computes in float32 (the bias corrections
``b ** step``, the schedule) are float32 tensors here too.  Everything
runs under `torch.no_grad()` and returns new tensors (the reference is
functional); nothing is updated in place.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .. import _tree

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar on the parameters' device
    m: PyTree
    v: PyTree


def _device_of(tree) -> torch.device:
    first = _tree.leaves(tree)
    return first[0].device if first else torch.device("cpu")


@torch.no_grad()
def adamw_init(params: PyTree) -> AdamWState:
    """Step 0 and float32 zero moments shaped like ``params``."""
    def zeros(p):
        # *_like: a DTensor parameter's moments keep its split
        return torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=_device_of(params)),
                      m=_tree.tree_map(zeros, params),
                      v=_tree.tree_map(zeros, params))


def _lr_at(lr, step: torch.Tensor):
    return lr(step) if callable(lr) else lr


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamWState, params: PyTree, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns ``(new_params, new_state)``.  ``lr`` is a number or a
    callable step -> float32 scalar (a schedule).  Gradients are first
    scaled by min(1, grad_clip / max(global norm, 1e-12)); the moments'
    bias corrections are 1 - b^step in float32."""
    step = state.step + 1
    lr_t = _lr_at(lr, step)
    if grad_clip:
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        grads = _tree.tree_map(lambda g: g.float() * scale, grads)
    stepf = step.float()
    b1t = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), stepf)
    b2t = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), stepf)

    def upd(p, g, m, v):
        g = g.float()
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mh = m2 / b1t
        vh = v2 / b2t
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p2 = p.float() - lr_t * delta
        return p2.to(p.dtype), m2, v2

    flat_p, treedef = _tree.flatten(params)
    out = [upd(*xs) for xs in zip(flat_p, _tree.leaves(grads),
                                  _tree.leaves(state.m),
                                  _tree.leaves(state.v))]
    new_params, new_m, new_v = _tree.transpose(treedef, 3, out)
    return new_params, AdamWState(step=step, m=new_m, v=new_v)


@torch.no_grad()
def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaves in
    the reference's order."""
    total = sum(torch.sum(torch.square(x.float()))
                for x in _tree.leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """``lr(step)`` (float32): linear warm-up to ``base_lr`` over
    ``warmup`` steps, then a cosine decay to ``min_ratio * base_lr`` at
    ``total``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr
