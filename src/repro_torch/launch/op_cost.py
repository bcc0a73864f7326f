"""Per-rank cost of a torch program from the aten ops it dispatches: the
port's counterpart of `repro.launch.hlo_cost`, which reads XLA's
optimised per-device HLO.  A torch program has no HLO; `OpCost` is a
`TorchDispatchMode` that counts each op as it runs, under the
reference's conventions:

  * dot flops = 2 * prod(output dims) * prod(contracting dims)
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``);
  * other arithmetic ~ 1 flop per output element; views, copies, casts
    to another layout and tensor factories count none;
  * bytes accessed = operands + output of each op; a gather or slice
    copy moves ~ its slice (2 * output bytes), a scatter ~ its update
    region (2 * its smallest operand), as in the reference; views move
    nothing;
  * collective bytes = the result bytes of each collective
    (``_c10d_functional`` and ``c10d`` ops, by kind), with counts.

It counts per rank: under DTensor it steps aside (returns
``NotImplemented``) so that DTensor's dispatch runs first and the mode
sees the local ops on this rank's shards and the collectives DTensor
issues — not the global product that `FlopCounterMode` reports for a
DTensor op.  Eager torch has no loop bodies whose trip counts multiply
their cost: every iteration dispatches its ops, so ``unparsed_loops`` is
always 0.  Eager bytes are unfused: every intermediate is written and
read again, so they read above XLA's fusion-aware count of the same
program.

DTensor works out each op's output shape by running the op on fake
tensors of the global shapes (its sharding propagation); `OpCost`
counts nothing while that runs.

With ``device`` given, only ops with an output on that device count:
a dry run keeps its shards on ``meta``, and DTensor's own bookkeeping
(shard sizes and offsets worked out on small CPU tensors) is no work of
the rank.

`OpCost` also keeps the peak of live bytes: each op's outputs are live
from their creation until their storage is freed (weak references), on
top of ``baseline`` bytes the caller names (the step's arguments).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

_DOTS = {
    aten.mm.default: lambda a, kw: a[0].shape[1],
    aten.addmm.default: lambda a, kw: a[1].shape[1],
    aten.bmm.default: lambda a, kw: a[0].shape[2],
    aten.baddbmm.default: lambda a, kw: a[1].shape[2],
}
_GATHERS = {aten.index.Tensor, aten.index_select.default,
            aten.embedding.default, aten.gather.default, aten.take.default,
            aten.take_along_dim.default}
_SCATTERS = {aten.index_put.default, aten.index_put_.default,
             aten._index_put_impl_.default, aten.scatter.src,
             aten.scatter.value, aten.scatter_add.default,
             aten.scatter_.src, aten.scatter_add_.default,
             aten.index_add.default, aten.index_add_.default,
             aten.slice_scatter.default, aten.select_scatter.default,
             aten.index_copy.default, aten.index_copy_.default}
# no arithmetic: copies, layout changes, factories, RNG states
_NO_FLOPS = {"copy_", "clone", "_to_copy", "contiguous", "empty",
             "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
             "ones_like", "full", "full_like", "new_empty", "new_zeros",
             "new_ones", "new_full", "new_empty_strided", "arange",
             "scalar_tensor", "lift_fresh", "lift_fresh_copy", "_unsafe_view",
             "cat", "stack", "constant_pad_nd", "repeat",
             "repeat_interleave", "fill_", "zero_", "detach", "alias",
             "set_", "resize_", "_local_scalar_dense"}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast_": "broadcast",
    "send": "send", "recv_": "recv",
}


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    return bool(getattr(func, "is_view", False))


class OpCost(TorchDispatchMode):
    """Counts flops, bytes and collectives of the ops dispatched while it
    is active (see the module's docstring); `result` reads them in the
    reference's `hlo_cost.analyze` layout."""

    def __init__(self, baseline: int = 0, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device)
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_by_kind: Dict[str, float] = {}
        self.coll_counts: Dict[str, int] = {}
        self.n_ops = 0
        self.live = int(baseline)
        self.peak = int(baseline)
        self._storages: Dict[int, Any] = {}
        self._quiet = 0
        self._patched = []

    def __enter__(self):
        # DTensor's shape propagation on global fake tensors is no work of
        # this rank: silence the mode while it runs
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        for name in ("_propagate_tensor_meta",
                     "_propagate_tensor_meta_non_cached"):
            orig = ShardingPropagator.__dict__.get(name)
            if orig is not None:
                setattr(ShardingPropagator, name, self._silenced(orig))
                self._patched.append((ShardingPropagator, name, orig))
        if not self._patched:
            raise RuntimeError(
                f"op_cost: torch {torch.__version__}'s ShardingPropagator "
                f"has no _propagate_tensor_meta: DTensor's global shape "
                f"propagation would be counted as this rank's work")
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for cls, name, orig in reversed(self._patched):
                setattr(cls, name, orig)
            self._patched.clear()

    def _silenced(self, fn):
        def run(*args, **kwargs):
            self._quiet += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._quiet -= 1
        return run

    # -- live bytes --------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- counting ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_wrapper(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if name == "wait_tensor":
            return
        outs = _tensors(out)
        if self.device is not None and outs and not any(
                t.device == self.device for t in outs):
            return
        out_bytes = sum(_nbytes(t) for t in outs)
        in_bytes = sum(_nbytes(t) for t in _tensors((args, kwargs)))
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            res = out_bytes or in_bytes
            self.coll_bytes += res
            self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0) + res
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            self.n_ops += 1
            self.bytes += res + in_bytes
            for t in outs:
                self._track(t)
            return
        if _is_view(func):
            return
        self.n_ops += 1
        for t in outs:
            self._track(t)
        if func in _DOTS:
            k = _DOTS[func](args, kwargs)
            fl = 2.0 * outs[0].numel() * k
            self.flops += fl
            self.dot_flops += fl
            self.bytes += out_bytes + in_bytes
        elif func in _GATHERS:
            self.bytes += 2 * out_bytes
        elif func in _SCATTERS:
            sizes = [_nbytes(t) for t in _tensors((args, kwargs))
                     if _nbytes(t)]
            self.bytes += 2 * (min(sizes) if sizes else out_bytes)
        elif name in _NO_FLOPS or ns not in ("aten", "prims"):
            self.bytes += out_bytes + in_bytes
        else:
            self.flops += sum(t.numel() for t in outs)
            self.bytes += out_bytes + in_bytes

    def result(self) -> Dict[str, Any]:
        return {
            "flops": self.flops, "dot_flops": self.dot_flops,
            "bytes": self.bytes, "coll_bytes": self.coll_bytes,
            "coll_by_kind": dict(self.coll_by_kind),
            "coll_counts": dict(self.coll_counts),
            "unparsed_loops": 0, "ops": self.n_ops,
            "peak_live_bytes": self.peak,
        }


def _is_wrapper(cls) -> bool:
    """A tensor subclass that wraps others (DTensor): its dispatch runs
    before the mode counts, so that the mode sees the local ops."""
    from torch.distributed.tensor import DTensor
    return issubclass(cls, DTensor)


def analyze(fn, *args, baseline: int = 0, device=None, **kwargs):
    """``(fn(*args, **kwargs), its cost)`` counted by `OpCost`."""
    with OpCost(baseline=baseline, device=device) as cost:
        out = fn(*args, **kwargs)
    return out, cost.result()
