"""Execution backends: where a round's client fan-out runs.

``local``: the whole cohort on one device. ``mesh``: the cohort's rows
spread over the ranks of a DeviceMesh (``torch.distributed``), parallel
strategy."""
from repro_torch.core.engine.backends.base import (ExecutionBackend,
                                                   LINEAR_AGGREGATORS,
                                                   axes_size)
from repro_torch.core.engine.backends.local import (LocalBackend,
                                                    make_parallel_round_core)
from repro_torch.core.engine.backends.mesh import MeshBackend


def _local_factory(*, device=None, **kw):
    return LocalBackend(device)


def _mesh_factory(*, mesh=None, strategy: str = "parallel",
                  reduce: str = "flat", device=None, **kw):
    """Default mesh: every rank of the process group on a (W, 1)
    ``("data", "model")`` mesh, the geometry ``launch/train.py --backend
    mesh`` uses. Pass a ``mesh`` to choose the topology."""
    if mesh is None:
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_distributed, make_mesh
        init_distributed(device)
        mesh = make_mesh((dist.get_world_size(), 1), ("data", "model"),
                         device)
    return MeshBackend(mesh, strategy=strategy, reduce=reduce)


#: name -> factory(**kw)
BACKENDS = {"local": _local_factory, "mesh": _mesh_factory}


def get_backend(name, **kw) -> ExecutionBackend:
    """A backend by name; an ``ExecutionBackend`` instance passes
    through."""
    if isinstance(name, ExecutionBackend):
        return name
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; known: "
                         f"{tuple(BACKENDS)}")
    return BACKENDS[name](**kw)


__all__ = ["ExecutionBackend", "LINEAR_AGGREGATORS", "LocalBackend",
           "MeshBackend", "make_parallel_round_core", "BACKENDS",
           "axes_size", "get_backend"]
