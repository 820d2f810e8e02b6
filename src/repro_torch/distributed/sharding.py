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
``MeshBackend(param_specs=...)``).

The tensor-parallel prefill (``make_prefill_step(mesh=...)``) computes by
other blocks than the rest layout's even cuts: ``compute_blocks`` gives a
``"model"`` rank its contiguous ``row_range`` block of query heads (any
H) and the kv heads those read, of d_ff, of the vocabulary and of the SSM
heads (``models/ssm.py::in_proj_columns`` maps these to their z, x and
dt columns of Mamba2's ``in_proj``, with all of B and C). A rank slices
them from whole leaves.
``ModelRank`` holds a rank's place under ``act_spec``, ``attn_kv_spec``
and ``moe_spmd_axes`` and the collectives that move the residual stream
between its layout and whole tensors.

Tensor-parallel training (``make_fed_train_step(mesh=...)``) runs the same
blocks with autograd on, on a ``ModelRank(train=True)``; ``ModelGrads``
sorts each param leaf's gradient into full, partial (summed over
``"model"`` every local step) and blocked (gathered from its owners after
the K steps).

The tensor-parallel decode (``make_serve_step(mesh=...)``) keeps each
rank's block of every decode-cache leaf in ``cache_pspecs``' layout
between steps: ``CacheLayout`` holds each leaf's spec and block shape,
allocates the blocks (``CacheBlocks``, which carry their layout) and
``gather_cache`` puts them together; ``DecodeRank`` is a rank's place in
the step (its batch rows by ``serve_input_pspecs``, each K/V block's
``KVPlace``). The encoder-decoder's prefill and decode run on a
``DecodeRank`` too; its cross cache (``xk``/``xv``, over the encoder
sequence) takes the K/V places, its blocks computed by the encoder run
(``CacheLayout.init(given=)``) and never written by a step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import collectives
from repro_torch.models.attention import QUANT_SCALES, HeadBlock, head_block
from repro_torch.models import attention, layers
from repro_torch.models import ssm as ssm_lib

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


# ---------------------------------------------------------------------------
# compute blocks of a "model" rank (the tensor-parallel prefill)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ComputeBlocks:
    """One ``"model"`` rank's blocks of a prefill of ``seq_len``
    positions: (lo, hi) of the sequence, d_model, d_ff, the vocabulary and
    the SSM heads (``row_range``), its ``HeadBlock``, and every rank's
    lengths of the blocks that are gathered (``*_sizes``, rank order)."""
    seq: Tuple[int, int]
    d: Tuple[int, int]
    ff: Tuple[int, int]
    vocab: Tuple[int, int]
    ssm: Tuple[int, int]
    heads: HeadBlock
    seq_sizes: Tuple[int, ...]
    d_sizes: Tuple[int, ...]
    vocab_sizes: Tuple[int, ...]
    kv_sizes: Tuple[int, ...]
    ssm_sizes: Tuple[int, ...]


def compute_blocks(cfg: ArchConfig, seq_len: int, size: int,
                   rank: int) -> ComputeBlocks:
    """Rank ``rank`` of ``size`` ``"model"`` ranks' compute blocks."""
    rr, sizes = collectives.row_range, collectives.range_sizes
    d_ff = cfg.d_ff if cfg.d_ff else 4 * cfg.d_model
    ssm_h = cfg.ssm.n_heads(cfg.d_model) if cfg.ssm is not None else 0
    H, KV = cfg.num_heads, cfg.num_kv_heads
    own = [head_block(H, KV, size, r).own for r in range(size)]
    return ComputeBlocks(
        seq=rr(seq_len, size, rank), d=rr(cfg.d_model, size, rank),
        ff=rr(d_ff, size, rank), vocab=rr(cfg.vocab_size, size, rank),
        ssm=rr(ssm_h, size, rank), heads=head_block(H, KV, size, rank),
        seq_sizes=tuple(sizes(seq_len, size)),
        d_sizes=tuple(sizes(cfg.d_model, size)),
        vocab_sizes=tuple(sizes(cfg.vocab_size, size)),
        kv_sizes=tuple(hi - lo for lo, hi in own),
        ssm_sizes=tuple(sizes(ssm_h, size)))


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def tensor_parallel_layout(act_spec, attn_kv_spec, moe_spmd_axes,
                           axis_names: Sequence[str]):
    """Parse the tensor-parallel specs against a mesh's axes. Returns
    (layout of the residual stream, the batch axes, whether K/V states are
    kept by key-sequence block, the MoE token groups' axes).
    ``act_spec``: (batch, seq, d), its ``"model"`` entry on seq or d (or
    none); ``attn_kv_spec``:
    (batch, key seq, kv heads, head dim), ``"model"`` on the key sequence
    or the kv heads (or none); their batch entries name the same axes.
    Refused by name: an axis the mesh lacks, ``"model"`` twice in one
    spec, ``"model"`` on a batch entry, another axis where ``"model"``
    goes, a spec of the wrong length, and MoE token groups over an axis
    other than ``"model"``."""
    names = tuple(axis_names)

    def check(spec, what, n, model_dims):
        if spec is None:
            return None, ()
        spec = tuple(spec)
        if len(spec) != n:
            raise ValueError(f"{what} {spec}: {n} entries, one a dim")
        flat = [a for e in spec for a in _names(e)]
        for a in flat:
            if a not in names:
                raise ValueError(f"{what} {spec} names axis {a!r}, which "
                                 f"the mesh {names} lacks")
        if flat.count("model") > 1:
            raise ValueError(f"{what} {spec} names 'model' twice")
        model_dim = None
        for dim, e in enumerate(spec[1:], 1):
            if not _names(e):
                continue
            if _names(e) != ("model",) or dim not in model_dims:
                raise ValueError(
                    f"{what} {spec}: dim {dim} is sharded over "
                    f"{_names(e)}; a tensor-parallel step takes "
                    f"'model' alone on dims {model_dims}")
            model_dim = dim
        if "model" in _names(spec[0]):
            raise ValueError(f"{what} {spec}: 'model' on the batch dim")
        return model_dim, _names(spec[0])

    a_dim, a_batch = check(act_spec, "act_spec", 3, (1, 2))
    k_dim, k_batch = check(attn_kv_spec, "attn_kv_spec", 4, (1, 2))
    if act_spec is not None and attn_kv_spec is not None and k_batch and \
            k_batch != a_batch:
        raise ValueError(f"attn_kv_spec's batch axes {k_batch} differ from "
                         f"act_spec's {a_batch}")
    moe_axes = tuple(moe_spmd_axes or ())
    for a in moe_axes:
        if a not in names:
            raise ValueError(f"moe_spmd_axes {moe_axes} names axis {a!r}, "
                             f"which the mesh {names} lacks")
        if a != "model":
            raise ValueError(f"moe_spmd_axes {moe_axes}: the token groups "
                             f"spread over the 'model' ranks, not {a!r}")
    layout = {1: "seq", 2: "d", None: None}[a_dim]
    return layout, a_batch or k_batch, k_dim == 1, moe_axes


class ModelRank:
    """This rank's place in the tensor-parallel prefill or train step on
    ``mesh``: the layout of the residual stream ("seq" or "d": by
    sequence or d_model block; None: whole on every "model" rank) and its
    batch axes (``tensor_parallel_layout``), its index among the
    ``"model"`` ranks (``size``, ``rank``) and among the batch axes'
    ranks, and the collectives of one prefill or loss, differentiable
    (``kernels.collectives``: each call site's backward is the adjoint of
    its place in the layer). An axis of one rank runs none. ``mesh``
    None: a model on one device, every block whole, no collective, the
    specs ignored (they change no value).

    ``train``: the train step's rank. The backend has already placed the
    batch's rows on this rank (the batch axes' split), so the rank reads
    all of them and gathers none back; K/V states are not kept, so
    ``attn_kv_spec`` sets no value."""

    def __init__(self, mesh=None, act_spec=None, attn_kv_spec=None,
                 moe_spmd_axes=None, train: bool = False):
        self.mesh = mesh
        if mesh is None:
            self.layout, self.batch_axes, self.kv_seq = None, (), False
            self.moe_axes, self.size, self.rank = (), 1, 0
            self.batch_index, self.batch_count = 0, 1
        else:
            (self.layout, self.batch_axes, self.kv_seq,
             self.moe_axes) = tensor_parallel_layout(
                act_spec, attn_kv_spec, moe_spmd_axes,
                mesh.mesh_dim_names)
            self.size = collectives.axes_size(mesh, ("model",))
            self.rank = (collectives.client_rank(mesh, ("model",))
                         if self.size > 1 else 0)
            self.batch_index, self.batch_count = collectives.block_index(
                mesh, self.batch_axes)
        if train:
            self.batch_index, self.batch_count, self.kv_seq = 0, 1, False
        if self.size > 1 and \
                dist.get_rank(mesh.get_group("model")) != self.rank:
            # the collectives place a block by the rank in the axis's
            # group; the blocks here are cut by ``rank``
            raise ValueError(f"'model' rank {self.rank} of the mesh is "
                             f"rank {dist.get_rank(mesh.get_group('model'))}"
                             f" of its process group")
        #: the ranks the MoE token groups spread over
        self.moe_size = self.size if "model" in self.moe_axes else 1
        #: sums a block's sum of squares over the ``"model"`` ranks for a
        #: norm over a dim they split (None where one rank holds it all)
        self.norm_reduce = self._norm_sum if self.size > 1 else None

    def blocks(self, cfg: ArchConfig, seq_len: int) -> ComputeBlocks:
        return compute_blocks(cfg, seq_len, self.size, self.rank)

    def batch_rows(self, n: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a batch of ``n``."""
        return collectives.row_range(n, self.batch_count, self.batch_index)

    # -- the residual stream: (B_r, S, d) whole, or its layout's block ----
    def _dim_of_layout(self, b: ComputeBlocks):
        return {"seq": (1, b.seq, b.seq_sizes),
                "d": (2, b.d, b.d_sizes)}[self.layout]

    def stream_block(self, x, b: ComputeBlocks):
        """This rank's block of the whole stream ``x`` (B_r, S, d), which
        every rank holds alike (backward: the blocks' cotangents
        all-gathered)."""
        if self.layout is None or self.size == 1:
            return x
        dim, _, sizes = self._dim_of_layout(b)
        return collectives.block_dim(x, self.mesh, "model", dim, sizes)

    def gather_stream(self, x, b: ComputeBlocks, partial: bool = True):
        """The whole stream from every rank's block: one all-gather.
        ``partial``: its readers are the rank's column blocks (backward:
        their cotangents reduce-scattered; with the stream whole, Megatron's
        ``enter``); else they compute alike on every rank (backward: this
        rank's block of the cotangent)."""
        if self.layout is None:
            return collectives.enter(x, self.mesh, "model") \
                if partial and self.size > 1 else x
        dim, _, sizes = self._dim_of_layout(b)
        return collectives.gather_dim(x, self.mesh, "model", dim, sizes,
                                      partial)

    def reduce_partial(self, h, b: ComputeBlocks):
        """A row-parallel product's partial sum (B_r, S, d), summed over the
        ``"model"`` ranks into the stream's layout: a reduce-scatter along
        its dim, or an all-reduce where the stream is whole."""
        if self.size == 1:
            return h
        if self.layout is None:
            return collectives.all_reduce_sum(h, self.mesh, "model")
        dim, _, sizes = self._dim_of_layout(b)
        return collectives.reduce_scatter_sum(h, self.mesh, "model", dim,
                                              sizes)

    def all_reduce(self, x):
        """The sum of every rank's partial, which every rank then reads
        alike."""
        if self.size == 1:
            return x
        return collectives.all_reduce_sum(x, self.mesh, "model")

    def _norm_sum(self, x):
        return collectives.all_reduce_sum(x, self.mesh, "model",
                                          partial=True)

    def gather(self, x, dim: int, sizes):
        """Every rank's block along ``dim``, whole on every rank, whose
        readers compute alike."""
        if self.size == 1:
            return x
        return collectives.gather_dim(x, self.mesh, "model", dim, sizes)

    def gather_batch(self, x, dim: int, n: int):
        """Every batch rank's rows of ``x`` along ``dim`` (``n`` in all),
        in order: one all-gather a batch axis of more than one rank, the
        innermost first."""
        sizes = collectives.range_sizes(n, self.batch_count)
        idx, span = self.batch_index, 1
        for a in reversed(self.batch_axes):
            asz = collectives.axes_size(self.mesh, (a,))
            if asz == 1:
                continue
            base = idx - idx % (span * asz)
            part = [sum(sizes[base + j * span:base + (j + 1) * span])
                    for j in range(asz)]
            x = collectives.gather_dim(x, self.mesh, a, dim, part)
            span *= asz
        return x


# ---------------------------------------------------------------------------
# the train step's gradients on the "model" ranks
# ---------------------------------------------------------------------------

_NORMS = ("ln1", "ln2", "ln")


def _leaf_reads(keys, cfg: ArchConfig, b: ComputeBlocks, layout,
                moe_spread: bool):
    """What one ``"model"`` rank of the train step reads of the param
    leaf at ``keys`` (its compute blocks ``b``): None where every rank
    computes the leaf's whole gradient alike (it reads the leaf whole on
    a tensor every rank holds alike); ``"all"`` where it reads it whole
    for a share of the work (a norm on its sequence block or under a
    partial cotangent, the MoE router and banks on its token groups), so
    its gradient is a partial; else (dim, [(lo, hi), ...]): the blocks
    along ``dim`` (from the end) it reads alone or with some others, from
    the ``param_blocks`` tables of the layers that cut them."""
    last, parent = keys[-1], keys[-2] if len(keys) > 1 else ""
    if keys[0] in ("embed", "final_norm", "lm_head"):
        return None
    if "moe" in keys:
        return "all" if moe_spread else None
    if parent in _NORMS:
        # a norm whose output every rank reads alike (the whole stream
        # entering the blocks, or the whole MoE input) gets whole
        # cotangents; a sequence block, or a partial cotangent, a share
        whole_moe = (parent == "ln2" and cfg.moe is not None and
                     keys[0] != "shared" and not moe_spread)
        if layout is None or (layout == "d" and whole_moe):
            return None
        return "all"
    if "ssm" in keys:
        table = ssm_lib.head_param_blocks(cfg, *b.ssm)
    else:
        table = {**attention.head_param_blocks(cfg, b.heads),
                 **layers.mlp_param_blocks(b.ff)}
    blk = table.get(last, table.get(parent))
    if blk is None:
        raise ValueError(f"param leaf {'/'.join(keys)}: no rule for its "
                         f"blocks on the 'model' ranks")
    return blk


@dataclass(frozen=True)
class LeafSplit:
    """A param leaf's blocks along ``dim`` (from the end) in the train
    step: ``shared``, the spans more than one ``"model"`` rank reads (their
    gradients are partials, summed every local step), and ``owned[r]``,
    the spans rank ``r`` alone reads (its gradient there is whole, its
    update the only one; every other rank's copy goes stale)."""
    dim: int
    shared: Tuple[Tuple[int, int], ...]
    owned: Tuple[Tuple[Tuple[int, int], ...], ...]

    def pieces(self, n: int):
        """[lo, hi) spans covering [0, n) in order, each (lo, hi, owner):
        a rank, "shared", or None (no rank reads it)."""
        marks = {}
        for lo, hi in self.shared:
            marks[lo] = (hi, "shared")
        for r, spans in enumerate(self.owned):
            for lo, hi in spans:
                marks[lo] = (hi, r)
        out, at = [], 0
        for lo in sorted(marks):
            hi, who = marks[lo]
            if lo > at:
                out.append((at, lo, None))
            out.append((lo, hi, who))
            at = hi
        if at < n:
            out.append((at, n, None))
        return out


def _split_of(reads, n: int, size: int, dim: int) -> LeafSplit:
    """A ``LeafSplit`` from every rank's reads (``_leaf_reads``) of a leaf
    of extent ``n`` along ``dim``."""
    if any(r == "all" for r in reads):
        return LeafSplit(dim, ((0, n),), ((),) * size)
    spans = [[(lo, hi) for lo, hi in r[1] if hi > lo] for r in reads]
    cuts = sorted({0, n} | {e for s in spans for span in s for e in span})
    shared, owned = [], [[] for _ in range(size)]

    def add(out, lo, hi):
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))

    for lo, hi in zip(cuts, cuts[1:]):
        who = [r for r, s in enumerate(spans)
               if any(a <= lo and hi <= c for a, c in s)]
        if len(who) > 1:
            add(shared, lo, hi)
        elif who:
            add(owned[who[0]], lo, hi)
    return LeafSplit(dim, tuple(shared), tuple(tuple(o) for o in owned))


class ModelGrads:
    """The gradients of the train step on the ``"model"`` ranks of the
    rank ``tp`` (a ``ModelRank``): each param leaf of ``params`` (a tree
    of tensors or of their shapes) is

    * *full*: every rank computed its whole gradient alike (the embedding,
      the final norm and readout, which run on the whole stream; the norms
      of a whole stream; the MoE leaves where every rank runs every
      token): nothing is done;
    * *partial*: each rank's gradient is a share (``LeafSplit.shared``: a
      kv head that several ranks' query heads read, Mamba2's B and C
      columns and conv channels, the norms on a sequence block or under a
      partial cotangent, the router and expert banks over token groups):
      summed over ``"model"`` every local step (``hook``), one all-reduce
      of all of them a dtype;
    * *blocked*: disjoint column or row blocks (``LeafSplit.owned``), each
      rank's SGD step updating its own; ``gather`` puts the clients'
      blocked leaves back together from their owners, one all-gather a
      leaf, once after the K steps.

    ``moe_spread``: whether the MoE token groups spread over the ranks."""

    def __init__(self, cfg: ArchConfig, tp: ModelRank, params: PyTree,
                 moe_spread: bool):
        self.mesh, self.rank = tp.mesh, tp.rank
        size = tp.size
        # a leaf's blocks do not depend on the sequence: any length will do
        blocks = [compute_blocks(cfg, 0, size, r) for r in range(size)]
        self.splits = {}
        for keys, leaf in iter_leaves(params):
            reads = [_leaf_reads(keys, cfg, b, tp.layout, moe_spread)
                     for b in blocks]
            if reads[0] is None:
                continue
            dim = -1 if reads[0] == "all" else reads[0][0]
            self.splits[keys] = _split_of(reads, int(leaf.shape[dim]), size,
                                          dim)

    def _map(self, fn, tree):
        return _map_with_path(
            lambda keys, t: fn(self.splits[keys], t) if keys in self.splits
            else t, tree)

    def hook(self, gather: bool = False):
        """``client_update``'s grad hook: the shared spans of every leaf's
        gradient summed over ``"model"`` (one all-reduce a dtype; it runs
        under ``torch.func.vmap`` too); ``gather``: the owned spans too,
        from their owners (the sequential strategy under ``param_specs``,
        whose step cuts rest blocks out of the whole gradient)."""
        def hook(grads, loss, batch):
            grads = self._sum_shared(grads)
            return (self.gather(grads) if gather else grads), loss
        return hook

    def _sum_shared(self, tree):
        parts = {}
        for keys, t in iter_leaves(tree):
            split = self.splits.get(keys)
            for lo, hi in (split.shared if split is not None else ()):
                parts.setdefault(t.dtype, []).append(
                    t.narrow(split.dim, lo, hi - lo).reshape(-1))
        if not parts:
            return tree
        sums = {dt: iter(torch.split(
            collectives.all_reduce_sum(torch.cat(ps), self.mesh, "model"),
            [p.shape[0] for p in ps])) for dt, ps in parts.items()}

        def splice(split, t):
            if not split.shared:
                return t
            out = []
            for lo, hi, who in split.pieces(t.shape[split.dim]):
                piece = t.narrow(split.dim, lo, hi - lo)
                out.append(next(sums[t.dtype]).reshape(piece.shape)
                           if who == "shared" else piece)
            return torch.cat(out, dim=split.dim)
        return self._map(splice, tree)

    def gather(self, tree):
        """Every leaf's owned spans from their owners (one all-gather a
        leaf with any), on whatever leading dims the leaves carry (a stack
        of clients, of cycles); outside ``torch.func.vmap``."""
        def fill(split, t):
            if not any(split.owned):
                return t
            dim = t.dim() + split.dim
            mine = [t.narrow(dim, lo, hi - lo)
                    for lo, hi in split.owned[self.rank]]
            sizes = [sum(hi - lo for lo, hi in o) for o in split.owned]
            mine = (torch.cat(mine, dim) if mine else
                    t.narrow(dim, 0, 0))
            got = collectives.all_gather_dim(mine, self.mesh, "model", dim,
                                             sizes)
            base = [sum(sizes[:r]) for r in range(len(sizes))]
            off = list(base)
            out = []
            for lo, hi, who in split.pieces(t.shape[dim]):
                if isinstance(who, int):
                    out.append(got.narrow(dim, off[who], hi - lo))
                    off[who] += hi - lo
                else:
                    out.append(t.narrow(dim, lo, hi - lo))
            return torch.cat(out, dim)
        return self._map(fill, tree)


# ---------------------------------------------------------------------------
# the decode cache's blocks, and a "model" rank's place in the decode step
# ---------------------------------------------------------------------------

class CacheBlocks(dict):
    """A decode cache as this rank's blocks: the cache's dict of leaves,
    each leaf this rank's block under ``layout`` (a ``CacheLayout``)."""
    layout = None


class CacheLayout:
    """A decode cache's layout on a mesh (``cache_pspecs``): for every
    leaf of the whole cache ``shapes`` (a tree of tensors on ``meta``,
    ``registry.cache_specs``), its spec (``specs``) and this rank's block
    shape (``blocks``). ``mesh``: a DeviceMesh, or None (one device:
    every block whole)."""

    def __init__(self, cfg: ArchConfig, shapes: PyTree, mesh):
        self.cfg, self.shapes, self.mesh = cfg, shapes, mesh
        self.mesh_shape = MeshShape.of(mesh)
        self.specs = cache_pspecs(cfg, shapes, self.mesh_shape)
        self.blocks = _map_with_path(
            lambda keys, spec: block_shape(
                _leaf_at(shapes, keys).shape, spec, self.mesh_shape),
            self.specs)
        #: the cache's batch (B)
        self.batch = next(int(t.shape[-3 if keys[-1] == "conv" else -4])
                          for keys, t in iter_leaves(shapes))

    def _new(self, tree) -> CacheBlocks:
        out = CacheBlocks(tree)
        out.layout = self
        return out

    def init(self, device, given=None) -> CacheBlocks:
        """This rank's blocks of a fresh cache on ``device``: zeros, the
        quantised cache's scales ones (``models/transformer.py::
        _block_cache``); the whole cache is never built. ``given``: a
        subtree of blocks computed elsewhere, taken as they are (the
        encoder-decoder's ``cross`` ``xk``/``xv``, filled by the encoder
        run and never written by a step), each checked against its block
        shape and dtype."""
        def make(keys, leaf):
            shape = _leaf_at(self.blocks, keys)
            block = _leaf_at(given, keys) if given is not None and \
                keys[0] in given else None
            if block is None:
                fill = torch.ones if keys[-1] in QUANT_SCALES else torch.zeros
                return fill(shape, dtype=leaf.dtype, device=device)
            if tuple(block.shape) != shape or block.dtype != leaf.dtype:
                raise ValueError(f"cache leaf {'/'.join(keys)}: a block "
                                 f"{tuple(block.shape)} {block.dtype}, its "
                                 f"layout's {shape} {leaf.dtype}")
            return block
        return self._new(_map_with_path(make, self.shapes))

    def map(self, fn) -> CacheBlocks:
        """This rank's blocks from ``fn(keys, spec)`` a leaf."""
        return self._new(_map_with_path(fn, self.specs))

    def block_bytes(self) -> int:
        """Bytes of this rank's blocks."""
        return block_bytes(self.shapes, self.specs, self.mesh_shape)

    def whole_bytes(self) -> int:
        """Bytes of the whole cache."""
        return sum(t.numel() * t.element_size()
                   for _, t in iter_leaves(self.shapes))


def _leaf_at(tree: PyTree, keys: Tuple[str, ...]):
    for k in keys:
        tree = tree[k]
    return tree


def gather_cache(cache: PyTree) -> PyTree:
    """The whole cache from every rank's blocks (``CacheBlocks``): one
    ``collectives.gather_leaf`` a leaf (one all-gather an axis of its
    spec). For checks: the decode step never holds the whole cache. A
    cache of one device (a plain dict) is returned as it is."""
    layout = getattr(cache, "layout", None)
    if layout is None:
        return cache
    return _map_with_path(
        lambda keys, t: collectives.gather_leaf(
            t, _leaf_at(layout.specs, keys), layout.mesh), dict(cache))


class DecodeRank(ModelRank):
    """This rank's place in the tensor-parallel decode step on ``mesh``
    (``make_serve_step(mesh=...)``): the residual stream (B_r, 1, d) whole
    on every ``"model"`` rank; the batch rows split evenly over the serve
    batch axes where ``batch`` divides them (``serve_input_pspecs``), else
    whole on every batch rank; the compute blocks of a one-token step
    (``blocks``, from the cache length); and each cache leaf's place
    (``kv_place``) under its ``cache_pspecs`` spec. ``mesh`` None: one
    device, every block whole, no collective."""

    def __init__(self, mesh, batch: int):
        super().__init__(mesh)
        shape = MeshShape.of(mesh)
        if mesh is not None and serve_input_pspecs(batch, shape)[0] \
                is not None:
            self.batch_axes = tuple(a for a in serve_batch_axes(shape)
                                    if a in shape.axis_names)
            self.batch_index, self.batch_count = collectives.block_index(
                mesh, self.batch_axes)

    def gather_entry(self, x, dim: int, entry):
        """``x`` whole along ``dim`` from the blocks of a spec entry's
        axes (``collectives.gather_leaf``: one all-gather an axis of more
        than one rank, the innermost first)."""
        return collectives.gather_leaf(
            x, PSpec(*([entry] + [None] * (x.dim() - 1 - dim))), self.mesh)

    def kv_place(self, spec: PSpec, shape, b: ComputeBlocks):
        """The place of a layer's K/V cache block under ``spec`` (its
        ``cache_pspecs`` spec; ``shape``: the whole leaf's shape, (...,
        B, L, KV, hd)): kv heads over ``"model"`` (this rank's block is
        the kv heads it owns, ``HeadBlock.own``), the head dim, the key
        sequence (over ``"model"``, or the batch axes and ``"model"``), or
        whole. The encoder-decoder's cross leaves ``xk``/``xv`` take the
        same places over L = the encoder sequence; ``to_heads`` then goes
        unused (no slot is written in them)."""
        from repro_torch.models.attention import KVPlace
        L, KV, hd = (int(n) for n in tuple(shape)[-3:])
        s_e, kv_e, hd_e = tuple(spec)[-3:]
        to_heads = None
        if self.size > 1:
            sizes = b.kv_sizes
            to_heads = lambda t: self.gather(t, t.dim() - 2, sizes)
        if kv_e == "model":
            n = KV // self.size
            span = (self.rank * n, (self.rank + 1) * n)
            if span != b.heads.own or span != b.heads.kv:
                raise ValueError(f"kv heads over 'model': rank "
                                 f"{self.rank}'s block {span} is not the kv "
                                 f"heads it owns {b.heads.own} and reads "
                                 f"{b.heads.kv}")
            return KVPlace(L, 2, span, to_heads)
        if hd_e == "model":
            n = hd // self.size
            return KVPlace(L, 3, (self.rank * n, (self.rank + 1) * n),
                           to_heads,
                           lambda t, d: self.gather_entry(t, d, hd_e))
        if s_e is not None:
            idx, count = collectives.block_index(self.mesh, _names(s_e))
            n = L // count
            return KVPlace(L, 1, (idx * n, (idx + 1) * n), to_heads,
                           lambda t, d: self.gather_entry(t, d, s_e))
        return KVPlace(L, None, (0, 0), to_heads)
