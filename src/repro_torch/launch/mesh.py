"""Mesh factories (port of `repro.launch.mesh`): `DeviceMesh`es with
named dimensions over the default process group.

Single pod : (16, 16)      dims ("data", "model")        = 256 ranks
Multi-pod  : (2, 16, 16)   dims ("pod", "data", "model") = 512 ranks

Every rank of the group must call a factory (a mesh spans the whole
world).  The group must be initialised already
(`torch.distributed.init_process_group`); nothing here initialises one.
A production mesh exists only on a world of 256 or 512 ranks — in
practice the host-only ``fake`` backend of a dry run (`launch.dryrun`).
The fleet engine's 1-D ``("fleet",)`` mesh is `_mesh.fleet_mesh`.
"""
from __future__ import annotations

from typing import Sequence

from .._mesh import group_world_size, mesh_device_type

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A `DeviceMesh` of ``shape`` over every rank of the default group,
    its dimensions named ``axes``; the world size must equal the product
    of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} against axes {axes}")
    world = group_world_size("make_mesh")
    n = 1
    for d in shape:
        n *= d
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process "
                         f"group has {world}")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape, axes = PRODUCTION[bool(multi_pod)]
    return make_mesh(shape, axes)


def make_host_mesh(n: int = 1, axes=("data", "model")):
    """An (n, 1) mesh over the world's ranks (tests and examples); ``n``
    is capped at the world size, which must then equal it."""
    return make_mesh((min(int(n), group_world_size("make_host_mesh")), 1),
                     axes)
