"""Execution backends: where a round's client fan-out runs.

``local``: the whole cohort on one device. ``mesh``: the cohort spread
over the ranks of a DeviceMesh (``torch.distributed``), by the parallel or
the sequential strategy. Both register in
``repro_torch.api.registries.BACKEND_REGISTRY``.
"""
import torch

from repro_torch.api.registries import BACKEND_REGISTRY, register_backend
from repro_torch.core.engine.backends.base import (ExecutionBackend,
                                                   LINEAR_AGGREGATORS,
                                                   axes_size)
from repro_torch.core.engine.backends.local import (
    LocalBackend, make_parallel_round_core, make_parallel_slab_cores)
from repro_torch.core.engine.backends.mesh import MeshBackend


def _local_factory(*, device=None, **kw):
    return LocalBackend(device)


def _mesh_factory(*, mesh=None, strategy: str = "parallel", groups: int = 1,
                  reduce: str = "flat", acc_dtype=torch.float32,
                  param_specs=None, device=None, **kw):
    """Default mesh: every rank of the process group on a (W, 1)
    ``("data", "model")`` mesh, the geometry ``launch/train.py --backend
    mesh`` uses. Pass a ``mesh`` to choose the topology. ``groups`` and
    ``acc_dtype`` are the sequential strategy's; ``param_specs`` shards
    the params (``distributed.sharding.param_pspecs``)."""
    if mesh is None:
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_distributed, make_mesh
        init_distributed(device)
        mesh = make_mesh((dist.get_world_size(), 1), ("data", "model"),
                         device)
    return MeshBackend(mesh, strategy=strategy, groups=groups,
                       acc_dtype=acc_dtype, reduce=reduce,
                       param_specs=param_specs)


register_backend("local", _local_factory)
register_backend("mesh", _mesh_factory)
BACKENDS = ("local", "mesh")   # builtins


def get_backend(name, **kw) -> ExecutionBackend:
    """A backend through ``BACKEND_REGISTRY``; an ``ExecutionBackend``
    instance passes through."""
    if isinstance(name, ExecutionBackend):
        return name
    return BACKEND_REGISTRY.get(name)(**kw)


__all__ = ["ExecutionBackend", "LINEAR_AGGREGATORS", "LocalBackend",
           "MeshBackend", "make_parallel_round_core",
           "make_parallel_slab_cores", "BACKENDS",
           "axes_size", "get_backend"]
