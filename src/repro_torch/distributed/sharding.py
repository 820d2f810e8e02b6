"""Sharding rules: params, batches and decode caches -> specs
(``repro.distributed.sharding``).

Mesh axes: ``("data", "model")`` on one pod, ``("pod", "data", "model")``
across pods (``launch.mesh``). The rules walk the port's param trees, which
carry the reference's key paths (``bridge.py``), and are divisibility-aware:
a dim is sharded only where the mesh axis divides it, so every block of a
leaf has the same shape.

A spec is ``PSpec``: one entry a dim, each ``None`` (not sharded), an axis
name, or a tuple of axis names (the first named axis major, as JAX's
``PartitionSpec``). The rules take any mesh with ``shape`` (axis name ->
size) and ``axis_names``: ``MeshShape`` (shape only, for accounting), or
``MeshShape.of(device_mesh)`` for a ``torch.distributed`` DeviceMesh.

Two parameter layouts, as the reference's:

* ``1d`` (tensor-parallel): matmul weights sharded over ``"model"`` only,
  column-parallel for up-projections (wq/wk/wv/gate/up/lm_head/in_proj),
  row-parallel for down-projections (wo/down/out_proj);
* ``2d`` (tensor-parallel + FSDP): the other matmul dim also over
  ``fsdp_axes`` (``("data",)``, or ``("data", "pod")`` across pods).

The port holds a rank's block of each leaf and gathers whole leaves where
they are read (``kernels.collectives.block_of``, ``gather_leaf``;
``MeshBackend(param_specs=...)``); the compute itself is not tensor-parallel
(ROADMAP A15).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

from repro_torch.configs.base import ArchConfig

PyTree = Any

# parent names whose kernels are column-parallel (shard the output dim) vs
# row-parallel (shard the input, contracting dim)
COL_PARALLEL = {"wq", "wk", "wv", "gate", "up", "lm_head", "in_proj",
                "fc", "fc1", "fc2", "out"}
ROW_PARALLEL = {"wo", "down", "out_proj"}


class PSpec(tuple):
    """A leaf's partition: one entry a dim (None, an axis name, or a tuple
    of axis names). A tuple, so ``PSpec("model", None) == ("model",
    None)``; ``tree_map`` treats it as a leaf. A tuple of one axis is that
    axis, as ``PartitionSpec`` normalises it. ``shape``: the whole leaf's
    shape where the spec was made from it (``param_pspecs``), else None."""

    shape = None

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):            # pickling: the entries again
        return tuple(self)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


class MeshShape:
    """A mesh's axis names and sizes, without devices: what the rules
    read. ``MeshShape.of`` adapts a DeviceMesh."""

    def __init__(self, shape, axis_names=None):
        """``shape``: {axis name: size}, or sizes with ``axis_names``."""
        if axis_names is None:
            self.shape = dict(shape)
        else:
            self.shape = dict(zip(tuple(axis_names),
                                  (int(s) for s in shape)))
        self.axis_names = tuple(self.shape)

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """A DeviceMesh's (or a ``MeshShape``'s) names and sizes; None (one
        device, no mesh) has no axes."""
        if isinstance(mesh, MeshShape):
            return mesh
        if mesh is None:
            return cls({})
        return cls(tuple(mesh.shape), tuple(mesh.mesh_dim_names))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def entry_size(mesh, entry) -> int:
    """Ranks a spec entry spans (1 for None)."""
    if entry is None:
        return 1
    size = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        size *= _axis_size(mesh, a)
    return size


def _div(dim: int, mesh, axis) -> bool:
    if axis is None:
        return False
    size = entry_size(mesh, axis)
    return size > 1 and dim % size == 0


def use_2d_params(cfg: ArchConfig, mesh, bytes_per_param: int = 2,
                  per_chip_budget_gb: float = 6.0) -> bool:
    """2d layout when 1d model-axis sharding would blow the per-chip
    budget."""
    from repro_torch.models import registry
    model = _axis_size(mesh, "model")
    gb = registry.param_count(cfg) * bytes_per_param / model / 1e9
    return gb > per_chip_budget_gb


def _rule_ndim(last: str, parent: str, shape) -> int:
    """Trailing dims the rule applies to (the rest are stacked leading
    dims)."""
    if last == "embedding" or last == "kernel":
        if len(shape) >= 4 and last == "kernel" and parent not in COL_PARALLEL \
                and parent not in ROW_PARALLEL and parent != "router":
            return 4                              # cnn conv kernel
        return 2
    if last in ("gate", "up", "down") and len(shape) >= 3:
        return 3
    if last in ("bias", "conv_b", "A_log", "D", "dt_bias", "scale"):
        return 1
    if last == "conv_w":
        return 2
    return len(shape)


def _param_rule(path_keys: Tuple[str, ...], shape: Tuple[int, ...],
                cfg: ArchConfig, mesh, two_d: bool,
                fsdp_axes: Tuple[str, ...] = ("data",)) -> PSpec:
    """The spec of one param leaf; leading stack dims get None."""
    keys = [str(k) for k in path_keys]
    last = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    n_lead = len(shape) - _rule_ndim(last, parent, shape)
    lead = (None,) * max(n_lead, 0)

    def spec(*tail):
        return PSpec(*(lead + tail))

    data_ax = (fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]) \
        if two_d else None

    if last == "embedding":                      # (V, d)
        v_ax = "model" if _div(shape[-2], mesh, "model") else None
        d_ax = data_ax if (two_d and _div(shape[-1], mesh, data_ax)) else None
        return spec(v_ax, d_ax)
    if last == "kernel":
        if parent in COL_PARALLEL:               # (in, out): col-parallel
            out_ax = "model" if _div(shape[-1], mesh, "model") else None
            in_ax = data_ax if (two_d and _div(shape[-2], mesh, data_ax)) \
                else None
            return spec(in_ax, out_ax)
        if parent in ROW_PARALLEL:               # (in, out): row-parallel
            in_ax = "model" if _div(shape[-2], mesh, "model") else None
            out_ax = data_ax if (two_d and _div(shape[-1], mesh, data_ax)) \
                else None
            return spec(in_ax, out_ax)
        if parent == "router":                   # small: replicated
            return spec(None, None)
        if len(shape) >= 4:                      # conv kernels (cnn)
            return spec(None, None, None, None)
        return spec(*(None,) * min(len(shape), 2))
    if last == "bias":
        if parent in COL_PARALLEL and _div(shape[-1], mesh, "model"):
            return spec("model")
        return spec(None)
    if last in ("gate", "up", "down") and len(shape) >= 3:
        # MoE expert banks (E, d, f) / (E, f, d): expert-parallel over
        # 'model' when E divides it, else the wide FFN dim
        E = shape[-3]
        if _div(E, mesh, "model"):
            d_ax = data_ax if (two_d and _div(shape[-2], mesh, data_ax)) \
                else None
            return spec("model", d_ax, None)
        wide = -1 if last in ("gate", "up") else -2
        axes = [None, None, None]
        if _div(shape[wide], mesh, "model"):
            axes[wide] = "model"
        other = -2 if wide == -1 else -1
        if two_d and _div(shape[other], mesh, data_ax):
            axes[other] = data_ax
        return spec(*axes)
    if last in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "scale"):
        return spec(*(None,) * _rule_ndim(last, parent, shape))
    return PSpec(*(None,) * len(shape))          # default: replicate


def iter_leaves(tree: PyTree, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of a nested dict, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from iter_leaves(v, path + (str(k),))
    else:
        yield path, tree


def _map_with_path(fn, tree: PyTree, path: Tuple[str, ...] = ()) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(cfg: ArchConfig, shapes: PyTree, mesh, two_d: bool = False,
                 fsdp_axes: Tuple[str, ...] = ("data",)) -> PyTree:
    """The spec tree of a params tree (``registry.shapes(cfg)``, meta
    tensors, or anything with ``shape``). ``fsdp_axes``: the axes the 2d
    dim shards over, ``("data",)`` on one pod, ``("data", "pod")`` to
    shard across pods too."""
    def rule(keys, leaf):
        spec = _param_rule(keys, tuple(leaf.shape), cfg, mesh, two_d,
                           tuple(fsdp_axes))
        spec.shape = tuple(int(s) for s in leaf.shape)
        return spec

    return _map_with_path(rule, shapes)


# ---------------------------------------------------------------------------
# batch and cache specs
# ---------------------------------------------------------------------------

def client_axes(mesh) -> Tuple[str, ...]:
    """Axes the FL client dimension shards over (the parallel strategy)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def fed_batch_pspecs(batch_shapes: Dict[str, Any], mesh,
                     strategy: str) -> Dict[str, PSpec]:
    """Round batches. Parallel, leaves (N, K, b, ...): N over the client
    axes. Sequential: dim 0 over ``"pod"`` where it divides, and dim 2 over
    ``"data"`` where it divides (the reference's rule, which reads dim 2 of
    the grouped (G, N/G, K, b, ...) leaves too)."""
    ca = client_axes(mesh)

    def rule(leaf):
        nd = len(leaf.shape)
        if strategy == "parallel":
            return PSpec(ca, *(None,) * (nd - 1))
        axes = [None] * nd
        if "pod" in mesh.axis_names and \
                leaf.shape[0] % _axis_size(mesh, "pod") == 0:
            axes[0] = "pod"
        if nd >= 3 and leaf.shape[2] % _axis_size(mesh, "data") == 0:
            axes[2] = "data"
        return PSpec(*axes)

    return {k: rule(v) for k, v in batch_shapes.items()}


def serve_batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def serve_input_pspecs(batch: int, mesh) -> PSpec:
    """Token batch (B,) for decode; a prefill's (B, S) takes it on dim 0."""
    ba = serve_batch_axes(mesh)
    return PSpec(ba) if batch % entry_size(mesh, ba) == 0 else PSpec(None)


def _cache_rule(keys, shape, mesh, ba, dsize) -> PSpec:
    last = keys[-1]
    if last in ("ks", "vs", "krs", "vrs"):
        # int8-cache scales (..., B, L, KV, 1): batch over data only
        lead = (None,) * (len(shape) - 4)
        b_ax = ba if shape[-4] % dsize == 0 else None
        return PSpec(*lead, b_ax, None, None, None)
    if last in ("k", "v", "kr", "vr", "xk", "xv"):
        B, S, KV, hd = shape[-4:]
        lead = (None,) * (len(shape) - 4)
        b_ax = ba if B % dsize == 0 else None
        msize = _axis_size(mesh, "model")
        if KV % msize == 0:
            return PSpec(*lead, b_ax, None, "model", None)
        if hd % msize == 0:
            # kv heads do not divide the model axis: shard head_dim
            return PSpec(*lead, b_ax, None, None, "model")
        if b_ax is None and S % (dsize * msize) == 0:
            return PSpec(*lead, None, ba + ("model",), None, None)
        if S % msize == 0:
            return PSpec(*lead, b_ax, "model", None, None)
        return PSpec(*lead, b_ax, None, None, None)
    if last == "ssm":
        B, H = shape[-4:-2]
        lead = (None,) * (len(shape) - 4)
        b_ax = ba if B % dsize == 0 else None
        h_ax = "model" if H % _axis_size(mesh, "model") == 0 else None
        return PSpec(*lead, b_ax, h_ax, None, None)
    if last == "conv":
        B, C = shape[-3], shape[-1]
        lead = (None,) * (len(shape) - 3)
        b_ax = ba if B % dsize == 0 else None
        c_ax = "model" if C % _axis_size(mesh, "model") == 0 else None
        return PSpec(*lead, b_ax, None, c_ax)
    return PSpec(*(None,) * len(shape))


def cache_pspecs(cfg: ArchConfig, cache_shapes: PyTree, mesh) -> PyTree:
    """Decode-cache specs. KV caches (..., B, S, KV, hd): batch over the
    serving batch axes, heads over ``"model"`` where they divide, else
    head_dim, else S. SSM states (..., B, H, N, P): batch and heads. Conv
    states (..., B, t, C): batch and channels."""
    ba = serve_batch_axes(mesh)
    dsize = entry_size(mesh, ba)
    return _map_with_path(
        lambda keys, leaf: _cache_rule(keys, tuple(leaf.shape), mesh, ba,
                                       dsize), cache_shapes)


# ---------------------------------------------------------------------------
# per-device accounting
# ---------------------------------------------------------------------------

def block_shape(shape, spec: PSpec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape`` under
    ``spec`` (leading dims beyond the spec unsharded)."""
    shape = tuple(int(s) for s in shape)
    lead = len(shape) - len(spec)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = entry_size(mesh, entry)
        if shape[lead + d] % n:
            raise ValueError(f"dim {lead + d} of {shape} does not divide "
                             f"among the {n} ranks of {entry!r}")
        out[lead + d] = shape[lead + d] // n
    return tuple(out)


def block_bytes(shapes: PyTree, specs: PyTree, mesh,
                itemsize=None) -> int:
    """Bytes of one rank's blocks of a tree of leaves with ``shape`` and
    ``dtype`` (or ``itemsize`` bytes an element for every leaf) under the
    spec tree ``specs`` of the same keys (``mesh``: a ``MeshShape``)."""
    leaves, spec_leaves = list(iter_leaves(shapes)), list(iter_leaves(specs))
    if [k for k, _ in leaves] != [k for k, _ in spec_leaves]:
        raise ValueError("the leaves and the specs differ in their keys")
    total = 0
    for (_, leaf), (_, spec) in zip(leaves, spec_leaves):
        n = 1
        for s in block_shape(leaf.shape, spec, mesh):
            n *= s
        size = itemsize if itemsize is not None else leaf.dtype.itemsize
        total += n * size
    return total
