"""Meshes and the process group of the port's multi-device round.

The port of ``repro/launch/mesh.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of one process
group, one process a device. ``init_distributed`` starts that group with
NCCL for a ``cuda`` device and gloo for ``cpu``, chosen by the device it is
given and by nothing else. Under ``torchrun`` the group's address, world
size and rank come from the environment (``env://``); without it the caller
passes them (``init_method="tcp://localhost:<port>"`` or
``"file://<path>"``, ``rank``, ``world_size``). A rank's device is
``cuda:LOCAL_RANK``.

A ``"model"`` axis may be larger than 1: ``MeshBackend(param_specs=...)``
holds each rank's block of the params under the specs of
``distributed.sharding``, and the ranks of one client row compute alike.
``make_production_mesh`` gives the reference's 256- and 512-device meshes
as a ``MeshShape``, for the sharding rules and the dry run's accounting.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

#: the process-group backend of each device type
PG_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(device: DeviceLike = None, *,
                     init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Start the default process group for ``device`` (``None`` means the
    card) unless one is running, and return this rank's device:
    ``cuda:LOCAL_RANK`` (made current) or ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else (rank or 0))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {} if rank is None else dict(rank=rank, world_size=world_size)
        dist.init_process_group(PG_BACKENDS[dev.type],
                                init_method=init_method, **kw)
    return dev


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: DeviceLike = None):
    """A DeviceMesh of ``shape`` over every rank of the process group
    (started by ``init_distributed(device)`` if none is running), with the
    axes ``axis_names``; ``device=None`` means the card."""
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                         f"in length")
    dev = init_distributed(device)
    if math.prod(shape) > dist.get_world_size():
        raise ValueError(f"mesh shape {shape} spans {math.prod(shape)} "
                         f"ranks; the process group has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_host_mesh(device: DeviceLike = None):
    """The degenerate 1x1 ``("data", "model")`` mesh (a world of one
    rank), for smoke runs of the mesh code paths."""
    return make_mesh((1, 1), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh, (16, 16) ``("data", "model")`` or
    (2, 16, 16) ``("pod", "data", "model")``, as a ``MeshShape``: names
    and sizes only. No 256-rank world exists here, so it serves the
    sharding rules (``distributed.sharding``) and the dry run's per-device
    accounting (``launch.dryrun``), never a process group."""
    from repro_torch.distributed.sharding import MeshShape
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))
