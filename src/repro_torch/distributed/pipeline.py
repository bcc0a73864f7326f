"""GPipe pipeline parallelism over a mesh's ``"stage"`` dimension (port of
`repro.distributed.pipeline`).

Stages are ranks along the stage dimension of a `DeviceMesh`; microbatches
stream through them, each activation moved to the next stage by P2P
sends and receives (`batch_isend_irecv`) where the reference uses
`jax.lax.ppermute` inside `shard_map`.  The schedule is the reference's
fill-drain: T = M + S - 1 ticks for M microbatches over S stages (bubble
fraction (S-1)/(M+S-1)); at tick t stage 0 takes in microbatch t, every
stage applies ``fn`` to what it holds, the last stage emits microbatch
t - (S-1), and each stage hands its output to the next.  The reference's
ring also sends the last stage's output to stage 0, which overwrites it
with the next microbatch (or zeros once all are in); that transfer is
dropped here.  The last stage's outputs are summed over the stage
dimension (an all-reduce, the reference's `psum`), so every stage
returns the whole result.

Self-contained: it pipelines any per-stage ``fn(params_stage, x) -> x``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .. import _tree


def _stage_params(params_stacked, stage: int):
    """This stage's slice of a tree whose leaves are stacked over the
    stages: a DTensor sharded over the stage dimension gives its local
    block, a whole tensor its row ``stage``."""
    from torch.distributed.tensor import DTensor

    def one(p):
        if isinstance(p, DTensor):
            return p.to_local()[0]
        return p[stage]
    return _tree.tree_map(one, params_stacked)


def pipeline_apply(fn: Callable, params_stacked, x: torch.Tensor, *, mesh,
                   stage_axis: str = "stage",
                   microbatches: Optional[int] = None,
                   stats: Optional[dict] = None) -> torch.Tensor:
    """``y = fn_S(... fn_1(x))`` with stage s on rank s of ``stage_axis``.

    ``params_stacked``: a tree whose leaves have a leading dim of the
    number of stages (whole on every rank, or DTensors sharded over the
    stage dimension).  ``x``: the (B, ...) batch, the same on every rank,
    split into ``microbatches`` (default: the number of stages).  Returns
    y, shaped like x, on every rank.  ``stats``, when given, receives the
    ticks, sends and receives of this rank."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    stage = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    M = microbatches or n_stages
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} must divide into {M} microbatches")
    mb = B // M
    params_me = _stage_params(params_stacked, stage)
    x_mb = x.reshape((M, mb) + tuple(x.shape[1:]))
    out = torch.zeros_like(x_mb)
    cur = torch.zeros_like(x_mb[0])
    nxt = dist.get_global_rank(group, stage + 1) \
        if stage + 1 < n_stages else None
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    T = M + n_stages - 1
    sends = recvs = 0
    for t in range(T):
        if stage == 0:
            cur = x_mb[t] if t < M else torch.zeros_like(cur)
        y = fn(params_me, cur)
        emit = t - (n_stages - 1)
        if stage == n_stages - 1 and 0 <= emit < M:
            out[emit] = y
        if t == T - 1:
            break
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
            sends += 1
        if prv is not None:
            cur = torch.empty_like(y)
            ops.append(dist.P2POp(dist.irecv, cur, prv, group))
            recvs += 1
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
    if stage != n_stages - 1:
        out.zero_()
    dist.all_reduce(out, group=group)
    if stats is not None:
        stats.update(ticks=T, sends=sends, recvs=recvs, stages=n_stages,
                     microbatches=M)
    return out.reshape(x.shape)
