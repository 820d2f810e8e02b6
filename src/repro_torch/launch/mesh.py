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

A ``"model"`` axis larger than 1 is refused: tensor-parallel parameters
are not ported yet (ROADMAP A13 (b)).
``make_production_mesh`` (the 256-device dry-run mesh) is not ported.
"""
from __future__ import annotations

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
    if "model" in names and shape[names.index("model")] > 1:
        raise ValueError(
            f"mesh axis 'model' of size {shape[names.index('model')]}: "
            f"tensor-parallel parameters are not ported yet: they come "
            f"with ROADMAP A13 (b); the 'model' axis must be 1")
    dev = init_distributed(device)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_host_mesh(device: DeviceLike = None):
    """The degenerate 1x1 ``("data", "model")`` mesh (a world of one
    rank), for smoke runs of the mesh code paths."""
    return make_mesh((1, 1), ("data", "model"), device)
