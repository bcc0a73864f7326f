"""Step factories of the port (`repro.launch.steps`): train, eval, prefill
and decode.

Each factory closes over the `ModelConfig` and returns a function of
tensors.  The train step differentiates `models.loss_fn` with
`torch.autograd.grad` on the plain paths (``impl="jnp"``, attention as
``cfg.attn_impl`` dispatches under autograd: the kernels have no
backward and raise if reached), accumulates ``cfg.microbatches``
microbatches' gradients in float32, applies the ``grad_tx`` hook (e.g.
`distributed.compression.EFCompressor`) and then `optim.adamw_update`.
The eval, prefill and decode steps run under `torch.no_grad()`, so on
the card they reach the kernels (with ``impl="pallas"``, their default
here, as the port's `forward` and `prefill` have it).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from .. import _tree
from ..models import ModelConfig, decode_step, loss_fn, prefill
from ..optim import adamw_init, adamw_update

PyTree = Any


def value_and_grad(params: PyTree, batch, cfg: ModelConfig, *,
                   impl: str = "jnp") -> Tuple[torch.Tensor, PyTree]:
    """(loss, gradients shaped like ``params``) of `loss_fn`; a leaf the
    loss does not reach gets a zero gradient, as under `jax.grad`."""
    flat, treedef = _tree.flatten(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in flat]
        loss = loss_fn(_tree.unflatten(treedef, live), batch, cfg,
                       impl=impl)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), _tree.unflatten(treedef, grads)


def _split(batch, M: int, i: int):
    """Microbatch ``i`` of ``M``: rows i·B/M .. (i+1)·B/M of every input,
    as the reference cuts them.  A DTensor input is cut from its whole
    rows (gathered: token ids and a few embeddings, small beside the
    step) and given back its placements, so that a MoE's capacity groups
    hold the reference's tokens."""
    return {k: _rows(v, M, i) for k, v in batch.items()}


def _rows(v, M: int, i: int):
    cut = (M, v.shape[0] // M) + tuple(v.shape[1:])
    if not isinstance(v, DTensor):
        return v.reshape(cut)[i]
    mesh, placements = v.device_mesh, v.placements
    whole = v.redistribute(mesh, [Replicate()] * mesh.ndim)
    return whole.reshape(cut)[i].redistribute(mesh, placements)


def make_train_step(cfg: ModelConfig, *, lr=3e-4, impl: str = "jnp",
                    grad_tx: Optional[Callable] = None):
    """``(params, opt_state, batch) -> (params, opt_state, loss)``.

    With ``cfg.microbatches`` = M > 1 the batch is cut into M equal
    microbatches; their gradients are summed in float32 and divided by M,
    their losses averaged.  ``grad_tx`` transforms the gradients before
    the AdamW update."""
    M = max(1, cfg.microbatches)

    def train_step(params, opt_state, batch):
        if M == 1:
            loss, grads = value_and_grad(params, batch, cfg, impl=impl)
        else:
            loss = 0.0
            # zeros_like: a DTensor parameter's accumulator keeps its split
            grads = _tree.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(M):
                l, g = value_and_grad(params, _split(batch, M, i), cfg,
                                      impl=impl)
                loss = loss + l
                grads = _tree.tree_map(lambda a, x: a + x.float(), grads, g)
            loss = loss / M
            grads = _tree.tree_map(lambda g: g / M, grads)
        if grad_tx is not None:
            grads = grad_tx(grads)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, loss

    return train_step


def make_eval_step(cfg: ModelConfig, *, impl: str = "pallas"):
    """``(params, batch) -> loss`` under `torch.no_grad()`."""
    @torch.no_grad()
    def eval_step(params, batch):
        return loss_fn(params, batch, cfg, impl=impl)
    return eval_step


def make_prefill_step(cfg: ModelConfig, max_seq: int, *,
                      impl: str = "pallas"):
    """``(params, batch) -> (cache, last-token logits)``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return prefill(params, batch, cfg, max_seq=max_seq, impl=impl)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``(params, tokens (B, 1), cache) -> (logits, cache)``; the cache is
    updated in place (`models.decode_step`)."""
    @torch.no_grad()
    def serve_step(params, tokens, cache):
        return decode_step(params, tokens, cache, cfg)
    return serve_step


def init_train_state(cfg: ModelConfig, params):
    return adamw_init(params)
