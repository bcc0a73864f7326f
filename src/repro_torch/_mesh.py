"""The fleet axis of the sharded engine: the mesh and its collectives.

The reference runs one process with a 1-D jax mesh over the ``"fleet"``
axis and `shard_map`.  Here every shard is a process, a rank of an
already-initialised default `torch.distributed` process group (NCCL for
ranks on the card, gloo for CPU ranks), and the mesh is a 1-D
`DeviceMesh` named ``("fleet",)`` over that group (`fleet_mesh`).  A
shard's offset and the fleet's size are what ``jax.lax.axis_index`` gives
the reference: ``rank x`` its rows, and ``size x`` them (`FleetAxis`).

The engine moves only this across shards (`api.engine`):

  * the ES demand, (D_local,) float64 (with the serving cell beside it
    when admission is per cell), all-gathered once a period for the
    global admission; under ``shard_by_cell`` the per-cell server loads
    all-reduced (SUM) instead;
  * the period's metrics, packed into three all-reduces: every counter as
    one int64 SUM vector, the accuracy as a float64 SUM vector, the worst
    violation and the makespan as a float64 MAX vector.

Collectives move tensors of the mesh's device type: ``"cuda"`` for NCCL,
``"cpu"`` for gloo.  A rank that computes on the card under a gloo mesh
copies each operand to the host and the result back, explicitly: several
ranks can then share one card (NCCL refuses two ranks on one GPU, and
gloo's collectives take CPU tensors).  That copy is chosen by the caller's
mesh, never by a failure.  `STATS` counts the collectives and their bytes
(`reset_stats` sets them to 0).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

FLEET_AXIS = "fleet"

# collectives issued, bytes of the gathered (global) vectors received, and
# bytes of the all-reduced operands, since the last `reset_stats`
STATS = {"collectives": 0, "bytes_gathered": 0, "bytes_reduced": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


def fleet_mesh(n_shards: Optional[int] = None):
    """A 1-D `DeviceMesh` over the default process group, its one
    dimension named ``"fleet"``.  The group must be initialised already
    (`torch.distributed.init_process_group`; this never initialises one)
    and its world size must equal ``n_shards`` (default: the world size).
    The mesh's device type is ``"cuda"`` for an NCCL group and ``"cpu"``
    for gloo."""
    from torch.distributed.device_mesh import init_device_mesh
    world = group_world_size("fleet_mesh")
    n = world if n_shards is None else int(n_shards)
    if n != world:
        raise ValueError(
            f"asked for {n} shards but the process group has {world} "
            f"ranks; one process per shard: start {n} processes and call "
            f"torch.distributed.init_process_group(world_size={n}) in each")
    return init_device_mesh(mesh_device_type(), (n,),
                            mesh_dim_names=(FLEET_AXIS,))


def group_world_size(what: str) -> int:
    """The default process group's world size; raises unless the group
    is initialised already (nothing here initialises one)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"{what} needs an initialised default process group: call "
            "torch.distributed.init_process_group(backend, init_method=, "
            "world_size=, rank=) in every rank's process first")
    return dist.get_world_size()


def mesh_device_type() -> str:
    """The device type a mesh over the default group moves: ``"cuda"``
    for NCCL, ``"cpu"`` for gloo (and the host-only ``fake`` backend)."""
    return "cuda" if str(dist.get_backend()).lower() == "nccl" else "cpu"


@dataclasses.dataclass(frozen=True)
class FleetAxis:
    """This rank's place on a mesh's fleet axis, and the collectives over
    it, for a shard that computes on ``compute``."""

    group: object             # the axis' ProcessGroup
    rank: int                 # this shard's index along the axis
    size: int                 # shards on the axis
    comm: torch.device        # where collectives move tensors
    compute: torch.device     # where this shard's tensors live

    @classmethod
    def of(cls, mesh, compute: torch.device) -> "FleetAxis":
        """The fleet axis of ``mesh`` for a shard computing on
        ``compute``.  A CPU shard needs a CPU (gloo) mesh."""
        dtype = mesh.device_type
        if compute.type == "cpu" and dtype != "cpu":
            raise ValueError(
                f"the shard computes on the CPU but the mesh moves {dtype} "
                f"tensors; build CPU ranks on a gloo group")
        return cls(group=mesh.get_group(FLEET_AXIS),
                   rank=mesh.get_local_rank(FLEET_AXIS),
                   size=mesh.size(), comm=torch.device(dtype),
                   compute=compute)

    def rows(self, d_local: int):
        """``(fleet size, this shard's rows as a slice)`` for shards of
        ``d_local`` devices."""
        start = self.rank * d_local
        return self.size * d_local, slice(start, start + d_local)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.comm.type == self.compute.type else x.to(
            self.compute)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (D_local, ...) of every shard, concatenated in rank order
        along dimension 0 (the reference's tiled ``all_gather``)."""
        src = x.to(self.comm).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        STATS["collectives"] += 1
        STATS["bytes_gathered"] += out.numel() * out.element_size()
        return self._out(out)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` summed (``op="sum"``) or maxed (``"max"``) over the
        shards, the same value on every rank."""
        buf = x.to(self.comm, copy=True).contiguous()
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        STATS["collectives"] += 1
        STATS["bytes_reduced"] += buf.numel() * buf.element_size()
        return self._out(buf)

    def reduce_metrics(self, counters: Dict[str, torch.Tensor],
                       sums: Dict[str, torch.Tensor],
                       maxes: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """The period's per-shard metrics made global in three
        collectives: ``counters`` (0-d integer tensors) summed as one
        int64 vector and handed back as int32, ``sums`` (0-d float64)
        summed, ``maxes`` (0-d float64) maxed."""
        out = {}
        for names, vec, op, dtype in (
                (list(counters), [v.to(torch.int64)
                                  for v in counters.values()], "sum",
                 torch.int32),
                (list(sums), list(sums.values()), "sum", None),
                (list(maxes), list(maxes.values()), "max", None)):
            if not names:
                continue
            red = self.all_reduce(torch.stack(vec), op)
            if dtype is not None:
                red = red.to(dtype)
            out.update(zip(names, red.unbind()))
        return out
