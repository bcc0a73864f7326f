"""Gradient compression with error feedback (int8 with a per-tensor
scale): the port of `repro.distributed.compression`.

Error feedback (Seide et al.) keeps each step's quantization residual and
adds it to the next step's gradient, so convergence is preserved.
`quantize_int8` rounds half to even, as `jnp.round` does, so the int8
values and the scale equal the reference's exactly on the same float32
input.

Usage: ``tx = EFCompressor(); step = make_train_step(cfg, grad_tx=tx)``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .. import _tree

PyTree = Any


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale): scale = max(|x|, 1e-12) / 127, the
    values round(x / scale) (half to even) clipped to [-127, 127]."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_tree(grads: PyTree, error: Optional[PyTree] = None
                  ) -> Tuple[PyTree, PyTree]:
    """(the dequantized gradients, as an all-reduce of int8 would deliver
    them, in each leaf's dtype; the new float32 residual)."""
    if error is None:
        error = _tree.tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)

    def one(g, e):
        corrected = g.float() + e
        deq = dequantize_int8(*quantize_int8(corrected))
        return deq.to(g.dtype), corrected - deq

    flat, treedef = _tree.flatten(grads)
    pairs = [one(g, e) for g, e in zip(flat, _tree.leaves(error))]
    return _tree.transpose(treedef, 2, pairs)


class EFCompressor:
    """Holds the error-feedback residual between steps (the convenience
    form for host-driven loops)."""

    def __init__(self):
        self.error: Optional[PyTree] = None

    def __call__(self, grads: PyTree) -> PyTree:
        out, self.error = compress_tree(grads, self.error)
        return out
