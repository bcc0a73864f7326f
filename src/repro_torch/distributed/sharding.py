"""Logical-axis sharding on DTensor (port of
`repro.distributed.sharding`).

Parameters, caches and activations are annotated with *logical* axis
names (`models.param_axes`, `models.cache_axes`, the layers' call sites);
a rule table maps each logical name to mesh dimensions.  `spec_for`
turns a leaf's axes into a `PartitionSpec` (one entry per tensor dim: a
mesh dimension's name, a tuple of them, or None), `placements_for` that
spec into DTensor placements on a `DeviceMesh` — `Shard(d)` on every
mesh dimension tensor dim d is split over, `Replicate()` elsewhere — and
`tree_shardings` a tree of axes into a tree of `NamedSharding`s, which
`distribute_tree` applies to a tree of tensors.

`sharding_context(mesh, rules)` installs the pair for the model code:
`shard_activation` then redistributes a DTensor activation to its
logical axes (the reference's `with_sharding_constraint`), and plain
tensors that meet a DTensor — positions, masks, RoPE tables, a batch
given whole to every rank — count as replicated (DTensor's implicit
replication, entered once with the context: nothing is converted when no
context is installed).  A plain tensor handed to a model under the
context must therefore be the same on every rank.

The rule tables are the reference's, value for value; a performance
change swaps rules, nothing else.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

PyTree = Any
Axes = Optional[Tuple[Optional[str], ...]]

_TLS = threading.local()


# --------------------------------------------------------------------------
# rule tables: logical axis -> mesh axis (str | tuple | None)
# --------------------------------------------------------------------------
def base_rules(multi_pod: bool = False, *, seq_shard: bool = False
               ) -> Dict[str, Any]:
    """Baseline rules (the reference's, value for value): the batch over
    ("pod", "data"); parameters tensor-parallel over "model" on their
    wide dims and FSDP-style over "data" on the embed dim; experts split
    inside each expert; a decode cache over "model" on its sequence;
    residual activations over "model" on the embed dim."""
    dp = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "seq": "data" if seq_shard else None,
        "cache_batch": dp,
        "cache_kv": None,
        "cache_seq": "model",
        "embed": "data",
        "vocab": "model",
        "in_vocab": "data",
        "in_embed": None,
        "qkv": "model",
        "kv": "model",
        "heads": "model",
        "mlp": "model",
        "expert": None,
        "expert_mlp": "model",
        "moe_group": dp,
        "lru": "model",
        "lru_block": None,
        "lru_block2": None,
        "conv": None,
        "ssm_in": None,
        "ssm_conv": None,
        "ssm_inner": "model",
        "ssm_heads": None,
        "layers": None,
        "act_embed": "model",
        "act_heads": "model",
        "act_mlp": "model",
    }


def decode_rules(multi_pod: bool = False, *, long_context: bool = False
                 ) -> Dict[str, Any]:
    """The base rules; with ``long_context`` (batch 1) every mesh axis on
    the cache's sequence dim and the batch unsharded."""
    r = base_rules(multi_pod)
    if long_context:
        r["cache_batch"] = None
        r["cache_seq"] = (("pod", "data", "model") if multi_pod
                          else ("data", "model"))
        r["batch"] = None
    return r


# --------------------------------------------------------------------------
# logical axes -> PartitionSpec -> placements
# --------------------------------------------------------------------------
class PartitionSpec(tuple):
    """One entry per leading tensor dim: a mesh dimension's name, a tuple
    of names (the dim split over each, outermost first), or None;
    trailing Nones are dropped and a one-name tuple is its name, as in
    `jax.sharding.PartitionSpec`."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                p = p[0] if len(p) == 1 else (p or None)
            norm.append(p)
        while norm and norm[-1] is None:
            norm.pop()
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _names(mesh_ax) -> Tuple[str, ...]:
    return tuple(mesh_ax) if isinstance(mesh_ax, (tuple, list)) \
        else (mesh_ax,)


def spec_for(axes: Axes, rules: Dict[str, Any]) -> PartitionSpec:
    """The spec of a leaf's logical ``axes`` under ``rules``; a mesh
    dimension already used by an earlier dim is dropped (a mesh dimension
    appears at most once in a spec)."""
    if axes is None:
        return PartitionSpec()
    parts = []
    used = set()
    for ax in axes:
        mesh_ax = rules.get(ax) if ax is not None else None
        if mesh_ax is not None:
            key = _names(mesh_ax)
            if any(k in used for k in key):
                mesh_ax = None
            else:
                used.update(key)
        parts.append(mesh_ax)
    return PartitionSpec(*parts)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{dimension name: size} of a `DeviceMesh`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements_for(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: `Shard(d)` on each mesh
    dimension tensor dim d is split over, `Replicate()` on the others.  A
    dim over several mesh dimensions must name them in the mesh's order
    (outermost first, as `Shard`s nest)."""
    order = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(order)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [order.index(nm) for nm in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} splits over {entry}, against the "
                             f"mesh's order {tuple(order)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's sharding: its mesh, spec and DTensor placements."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """This rank's local shape of a tensor of ``global_shape`` (a
        shape computation: it runs outside any fake-tensor mode)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        with unset_fake_temporarily():
            shape, _off = compute_local_shape_and_global_offset(
                tuple(global_shape), self.mesh, self.placements)
        return tuple(int(d) for d in shape)


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x))


def map_axes(fn, axes_tree: PyTree) -> PyTree:
    """``fn(axes)`` at every leaf of a tree of logical-axes tuples (None
    a leaf; dicts, lists and tuples of subtrees walked; an empty tuple an
    empty container, as in the reference)."""
    if axes_tree == ():
        return ()
    if _is_axes(axes_tree):
        return fn(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v) for k, v in axes_tree.items()}
    return type(axes_tree)(map_axes(fn, v) for v in axes_tree)


def zip_axes(tree: PyTree, axes_tree: PyTree):
    """(leaf, axes) pairs of a tree and its axes tree, dict keys sorted
    (`jax.tree_util`'s order)."""
    if axes_tree == ():
        return
    if _is_axes(axes_tree):
        yield tree, axes_tree
    elif isinstance(axes_tree, dict):
        for k in sorted(axes_tree):
            yield from zip_axes(tree[k], axes_tree[k])
    else:
        for t, a in zip(tree, axes_tree):
            yield from zip_axes(t, a)


def tree_shardings(axes_tree: PyTree, mesh, rules: Dict[str, Any]
                   ) -> PyTree:
    """A tree of logical-axis tuples as a tree of `NamedSharding`s."""
    return map_axes(lambda axes: NamedSharding(mesh, spec_for(axes, rules)),
                    axes_tree)


def distribute_tree(tree: PyTree, shardings: PyTree) -> PyTree:
    """Every tensor of ``tree`` as a DTensor with its sharding (from the
    whole tensor, which every rank holds alike); anything else kept."""
    if isinstance(shardings, NamedSharding):
        if not isinstance(tree, torch.Tensor):
            return tree
        return distribute_tensor(tree, shardings.mesh, shardings.placements)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(distribute_tree(t, s)
                          for t, s in zip(tree, shardings))
    return tree


def validate_divisibility(shape_tree: PyTree, axes_tree: PyTree, mesh,
                          rules: Dict[str, Any]) -> None:
    """Raise early (naming the leaf) if a sharded dim does not divide its
    mesh dimensions' size."""
    sizes = mesh_sizes(mesh)
    for leaf, axes in zip_axes(shape_tree, axes_tree):
        if axes is None or not hasattr(leaf, "shape"):
            continue
        for dim, ax in zip(leaf.shape, axes):
            mesh_ax = rules.get(ax) if ax else None
            if mesh_ax is None:
                continue
            names = _names(mesh_ax)
            total = 1
            for nm in names:
                total *= sizes[nm]
            if dim % total:
                raise ValueError(
                    f"dim {dim} (logical '{ax}') not divisible by mesh "
                    f"{names} (={total}) for leaf {tuple(leaf.shape)}/"
                    f"{axes}")


# --------------------------------------------------------------------------
# activation-sharding context
# --------------------------------------------------------------------------
@contextlib.contextmanager
def sharding_context(mesh, rules: Dict[str, Any]):
    """Install (mesh, rules) for `shard_activation`, and DTensor's implicit
    replication of plain tensors, until the block exits."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        _TLS.ctx = prev


def unshard(x, dim: Optional[int] = None):
    """``x`` with no pending sum and, given ``dim``, that dim whole on
    every rank: its `Partial` (and `Shard(dim)`) placements made
    `Replicate()`, the other shards kept; a plain tensor itself.  Goes
    around an op whose DTensor strategy fails on a split dim or a partial
    sum."""
    if not isinstance(x, DTensor):
        return x
    split = None if dim is None else Shard(dim % x.ndim)
    want = tuple(Replicate() if p == split or p.is_partial() else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def evened(x):
    """``x`` with every dim that is split unevenly over its mesh
    dimensions (24 heads on a 16-wide axis) gathered whole: DTensor keeps
    such a split but cannot reshape across it.  A plain tensor itself."""
    if not isinstance(x, DTensor):
        return x
    n = {}
    for size, p in zip(x.device_mesh.shape, x.placements):
        if isinstance(p, Shard):
            n[p.dim] = n.get(p.dim, 1) * size
    want = tuple(Replicate() if isinstance(p, Shard) and x.shape[p.dim]
                 % n[p.dim] else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def batch_split_only(x):
    """``x`` split along its first dim alone (every other split gathered,
    pending sums reduced): what DTensor (torch 2.11) accepts where an
    einsum folds several dims into one; a plain tensor itself."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def on_local_rows(fn, *tensors):
    """``fn`` of per-row work (each output row depending on its own input
    rows alone), returning a tuple, run on every rank's own rows: DTensor
    inputs split along their first dim alone, the same way, then
    `to_local`; the outputs wrapped back with that split.  Plain inputs:
    ``fn(*tensors)``.  A 1-d input (per-head constants) is taken whole.
    The layers hand the kernels their DTensor inputs this way (a kernel
    takes plain tensors), and go around ops DTensor has no strategy for
    (torch 2.11)."""
    lead = next((t for t in tensors if isinstance(t, DTensor)
                 and t.ndim > 1), None)
    if lead is None:
        return fn(*tensors)
    mesh = lead.device_mesh
    want = batch_split_only(lead).placements
    local = [whole(t) if t.ndim < 2 else
             t.redistribute(mesh, want).to_local()
             if isinstance(t, DTensor) else t for t in tensors]
    out = fn(*local)
    return tuple(DTensor.from_local(o, mesh, want, run_check=False)
                 for o in out)


def split_ready(x, dim: int, parts: int):
    """``x`` ready for its dim ``dim`` to be split into (``parts``, rest)
    by a reshape: a DTensor sharded on that dim over a number of ranks
    that does not divide ``parts`` (4 heads on a 16-wide model axis) has
    the dim gathered whole (`unshard`) — DTensor cannot reshape an uneven
    split; anything else is returned as is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        if p == Shard(dim):
            n *= size
    return x if parts % n == 0 else unshard(x, dim)


class _SplitReadyGrad(torch.autograd.Function):
    """Identity forward; `split_ready` (``parts`` > 0) or
    `batch_split_only` (``parts`` 0) on the gradient."""

    @staticmethod
    def forward(ctx, x, dim, parts):
        ctx.dim, ctx.parts = dim, parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = (split_ready(g, ctx.dim, ctx.parts) if ctx.parts
             else batch_split_only(g))
        return g, None, None


def grad_batch_split_only(x):
    """``x`` whose gradient arrives split along its first dim alone
    (`batch_split_only`); a plain tensor, or one that autograd does not
    record, as is."""
    if not isinstance(x, DTensor) or not (torch.is_grad_enabled()
                                          and x.requires_grad):
        return x
    return _SplitReadyGrad.apply(x, 0, 0)


def whole(x):
    """A DTensor's whole tensor on every rank, as a plain tensor inside
    autograd (gathered, then `to_local`); anything else as is.  With
    `replicated` it goes around code that DTensor has no strategy for."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def replicated(x, mesh):
    """A plain tensor, the same on every rank, as a replicated DTensor."""
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def merged(x, dim: int, parts: int):
    """``x``, a reshape's merge of ``parts`` blocks into dim ``dim`` (the
    heads into the model width), whose gradient — split back by the
    reshape's backward — is made `split_ready` first; a plain tensor, or
    one that autograd does not record, is returned as is."""
    if not isinstance(x, DTensor) or not (torch.is_grad_enabled()
                                          and x.requires_grad):
        return x
    return _SplitReadyGrad.apply(x, dim, parts)


def gather_params(params):
    """Parameters at their use — one tensor, or a layer's dict of them —
    under a sharding context: each DTensor's shards over the fully
    sharded data-parallel mesh dimensions (those the rules give "embed"
    and "in_vocab", FSDP/ZeRO-3 style) gathered whole, its
    tensor-parallel shards kept; autograd reduce-scatters the gradients
    on the way back.  XLA inserts these all-gathers for the reference;
    DTensor would otherwise move the activations to the weights.  Without
    a context the argument itself."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return params
    mesh, rules = ctx
    fsdp = set()
    for ax in ("embed", "in_vocab"):
        if rules.get(ax) is not None:
            fsdp.update(_names(rules[ax]))
    dims = [i for i, nm in enumerate(mesh.mesh_dim_names) if nm in fsdp]

    def one(t):
        if not isinstance(t, DTensor):
            return t
        want = tuple(Replicate() if i in dims and p.is_shard() else p
                     for i, p in enumerate(t.placements))
        return t if want == tuple(t.placements) else t.redistribute(
            t.device_mesh, want)
    if isinstance(params, dict):
        return {k: one(v) for k, v in params.items()}
    return one(params)


def shard_activation(x, *logical_axes: Optional[str]):
    """``x`` redistributed to its ``logical_axes`` when a sharding context
    is installed and ``x`` is a DTensor; otherwise ``x`` itself.  Axes
    whose dim does not divide their mesh dimensions are dropped (e.g. 56
    q heads on a 16-wide model axis): that dim is then replicated."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    sizes = mesh_sizes(mesh)
    eff = []
    for dim, ax in zip(x.shape, logical_axes):
        mesh_ax = rules.get(ax) if ax else None
        if mesh_ax is not None:
            total = 1
            for nm in _names(mesh_ax):
                total *= sizes[nm]
            if dim % total:
                ax = None
        eff.append(ax)
    want = placements_for(spec_for(tuple(eff), rules), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
