"""The client axis's collectives: ``torch.distributed`` over a DeviceMesh.

The reference's client-sharded kernels run their Pallas body on each
shard inside a ``shard_map`` and sum the per-shard partials with
``jax.lax.psum`` (``psum_tiers``, ``repro/kernels/fedavg_reduce.py:44``).
In the port each rank holds its own block of client rows, runs the
single-device kernel on them, and a collective outside the kernel sums or
gathers across ranks: NCCL on the card, gloo on the CPU, whichever group
the mesh was built on (``launch.mesh``).

Every rank holds a contiguous block of the round's client rows
(``row_range``); a block may be one row longer than another, so a cohort
need not divide among the ranks. ``counts`` counts the collectives run
in this process, by kind.

The sequential strategy reduces over one axis at a time: the client
groups' sums over ``"pod"`` and each local step's gradients over
``"data"`` (``all_reduce_axis``, ``all_gather_axis``); an axis of one
rank runs no collective.

Sharded parameters (``MeshBackend(param_specs=...)``): ``block_of`` cuts a
whole leaf to this rank's block under a spec (``distributed.sharding``),
``gather_leaf`` puts the whole leaf back together from every rank's block,
one all-gather an axis of the spec. A dim split over a tuple of axes takes
the first named axis as major, as JAX's ``PartitionSpec``. On a world of
one rank both are the identity and run no collective.

Tensor-parallel compute (the prefill's ``act_spec``): ``all_gather_dim``
puts a tensor back together along one dim from the blocks of one axis's
ranks, which may differ in length (``row_range``'s, or any lengths the
caller names), and ``reduce_scatter_dim`` sums every rank's whole partial
and keeps this rank's ``row_range`` block of one dim. gloo has no
reduce-scatter, so it is an all-reduce followed by a slice on every
backend, one code path for gloo and NCCL. An axis of one rank runs
neither. ``nbytes`` counts the bytes of each kind's results on this rank.

The block path's collectives (``distributed.sharding.ModelRank``) are
``torch.autograd.Function``s (``gather_dim``, ``reduce_scatter_sum``,
``block_dim``, ``all_reduce_sum``, ``enter``), so a loss on the
``"model"`` ranks differentiates through them, under ``torch.func.grad``
and ``torch.func.vmap`` too: each has a ``vmap`` rule that runs one
collective on the whole batch (the vmapped dim moved to the front, the
collective's dim counted from the end), and its backward is its adjoint,
itself such a Function. A cotangent is *partial* where each rank holds a
share of it, summed over the ranks (a rank's column blocks read a whole
input), and *whole* where every rank holds all of it alike. So an
all-gather whose readers are column blocks has a reduce-scatter for its
backward, and one whose readers compute alike on every rank takes this
rank's block; a row-parallel sum into a whole stream has the identity,
Megatron's ``enter`` the all-reduce. Their forwards are the plain
functions', bit for bit; no Function writes into its input.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: collectives run by this process, by kind
counts = {"all_reduce": 0, "all_gather": 0, "all_gather_dim": 0,
          "reduce_scatter_dim": 0}
#: bytes of those collectives' results on this rank, by kind
nbytes = dict.fromkeys(counts, 0)
#: the process group over all the ranks of a mesh that spans less than the
#: world (a fleet's sub-mesh), by the mesh's ranks (``register_span``)
_SPANS = {}


def _ranks_key(mesh) -> tuple:
    return tuple(mesh.mesh.reshape(-1).tolist())


def register_span(mesh, group) -> None:
    """Record ``group`` (built by every rank, ``dist.new_group``) as the
    group over all the ranks of ``mesh``, for collectives over axes that
    span it (``backends.mesh.carve_submeshes``)."""
    _SPANS[_ranks_key(mesh)] = group


def axes_size(mesh, axes) -> int:
    """Product of the named mesh axes' sizes (1 for no mesh or no axes;
    an axis the mesh lacks counts 1)."""
    if mesh is None or not axes:
        return 1
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in axes if a in names)


def client_group(mesh, axes: Sequence[str]):
    """The process group over the mesh axes ``axes`` taken together: one
    axis's group, or, when the axes are the whole mesh (every other axis
    of size 1), the default group or the group registered for a mesh
    over part of the world (``register_span``)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if axes_size(mesh, axes) == mesh.size():
        if mesh.size() == dist.get_world_size():
            return dist.group.WORLD
        group = _SPANS.get(_ranks_key(mesh))
        if group is not None:
            return group
    raise ValueError(f"axes {axes} of the mesh {tuple(mesh.mesh_dim_names)} "
                     f"{tuple(mesh.shape)} must span the mesh, and the mesh "
                     f"the world or a group registered for it")


def client_rank(mesh, axes: Sequence[str]) -> int:
    """This rank's place among the ranks of the client axes: the index of
    its block of client rows, and of its slice in a gather."""
    return dist.get_rank(client_group(mesh, axes))


def row_range(n: int, size: int, rank: int) -> Tuple[int, int]:
    """Rows [lo, hi) of ``n`` that rank ``rank`` of ``size`` holds: the
    first ``n % size`` ranks hold one row more."""
    q, r = divmod(n, size)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


def check_tiers(axes: Sequence[str], reduce_tiers) -> Tuple[tuple, ...]:
    """``reduce_tiers`` as a tuple of axis tuples; raises unless their
    concatenation covers ``axes`` exactly (the reference's rule)."""
    tiers = tuple(tuple(t) for t in reduce_tiers)
    flat = tuple(a for t in tiers for a in t)
    if sorted(flat) != sorted(tuple(axes)):
        raise ValueError(f"reduce_tiers {tiers} do not partition client "
                         f"axes {tuple(axes)}")
    return tiers


def all_reduce_tiers(x: torch.Tensor, mesh, client_axes: Sequence[str],
                     reduce_tiers=None) -> torch.Tensor:
    """Sum ``x`` in place over the client axes and return it: one
    all-reduce over all of them (``reduce_tiers`` None), or one per tier,
    in the order given (innermost first, e.g. ``(("data",), ("pod",))``:
    within each pod, then across pods). Sums over disjoint groups compose
    to the flat sum, in another order (within 1e-6)."""
    groups = ([client_group(mesh, client_axes)] if reduce_tiers is None
              else [client_group(mesh, t)
                    for t in check_tiers(client_axes, reduce_tiers)])
    if x.numel() == 0:                 # the same on every rank: no sum
        return x
    for group in groups:
        dist.all_reduce(x, group=group)
        _count("all_reduce", x)
    return x


def _count(kind: str, out: torch.Tensor) -> None:
    counts[kind] += 1
    nbytes[kind] += out.numel() * out.element_size()


def _gather(out: torch.Tensor, x: torch.Tensor, group,
            kind: str = "all_gather") -> torch.Tensor:
    dist.all_gather_into_tensor(out, x, group=group)
    _count(kind, out)
    return out


def all_gather_flat(x: torch.Tensor, mesh,
                    axes: Sequence[str]) -> torch.Tensor:
    """Concatenate every client rank's (m,) ``x``, in rank order: one
    ``all_gather_into_tensor``; every rank's ``x`` has the same size."""
    group = client_group(mesh, axes)
    out = torch.empty((dist.get_world_size(group) * x.shape[0],),
                      dtype=x.dtype, device=x.device)
    return _gather(out, x.contiguous(), group)


def all_gather_rows(x: torch.Tensor, mesh,
                    axes: Sequence[str]) -> torch.Tensor:
    """Concatenate every client rank's block of rows ``x`` (n_r, ...) along
    dim 0, in rank order, on every rank. The blocks may differ in length:
    the lengths are gathered first, then the blocks, padded to the
    longest."""
    group = client_group(mesh, axes)
    size = dist.get_world_size(group)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    lens = _gather(torch.empty((size,), dtype=torch.int64, device=x.device),
                   n, group).tolist()
    pad = max(lens)
    block = torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    block[:x.shape[0]] = x
    out = torch.empty((size * pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _gather(out, block, group)
    return torch.cat([out[r * pad:r * pad + k] for r, k in enumerate(lens)])


def rows_of(mesh, axes: Optional[Sequence[str]], n: int) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of an ``n``-row client stack."""
    return row_range(n, axes_size(mesh, axes), client_rank(mesh, axes))


# ---------------------------------------------------------------------------
# one axis's sub-groups (the sequential strategy: groups over "pod", each
# client's batch over "data")
# ---------------------------------------------------------------------------

def axis_range(mesh, axis: str, n: int) -> Tuple[int, int]:
    """This rank's block [lo, hi) of ``n`` items spread over the ranks of
    one mesh axis (``row_range``): the ranks that share this rank's place
    on the other axes form the sub-group. All ``n`` where the axis has
    one rank or the mesh lacks it."""
    size = axes_size(mesh, (axis,))
    if size == 1:
        return 0, n
    return row_range(n, size, client_rank(mesh, (axis,)))


def all_reduce_axis(x: torch.Tensor, mesh, axis: str,
                    reduce_tiers=None) -> torch.Tensor:
    """``all_reduce_tiers`` over the sub-group of one mesh axis; nothing
    runs where that axis has one rank."""
    if axes_size(mesh, (axis,)) == 1:
        return x
    return all_reduce_tiers(x, mesh, (axis,), reduce_tiers)


def all_gather_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``all_gather_rows`` over the sub-group of one mesh axis; ``x``
    itself where that axis has one rank."""
    if axes_size(mesh, (axis,)) == 1:
        return x
    return all_gather_rows(x, mesh, (axis,))


# ---------------------------------------------------------------------------
# parameter blocks (``distributed.sharding`` specs)
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    """A spec entry's axes, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def block_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's index, the number of blocks) of a dim split over
    ``axes``, the first named axis major."""
    idx, count = 0, 1
    for a in axes:
        size = axes_size(mesh, (a,))
        idx = idx * size + (client_rank(mesh, (a,)) if size > 1 else 0)
        count *= size
    return idx, count


def block_of(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under ``spec`` (its
    trailing dims; leading dims beyond the spec are whole), as a tensor of
    its own (not a view that keeps the whole leaf alive). ``x`` itself
    where nothing of it is split."""
    lead = x.dim() - len(spec)
    out = x
    for d, entry in enumerate(spec):
        i, n = block_index(mesh, _entry_axes(entry))
        if n == 1:
            continue
        size = x.shape[lead + d] // n
        if size * n != x.shape[lead + d]:
            raise ValueError(f"dim {lead + d} of {tuple(x.shape)} does not "
                             f"divide among the {n} ranks of {entry!r}")
        out = out.narrow(lead + d, i * size, size)
    return out if out is x else out.clone(
        memory_format=torch.contiguous_format)


def _gather_dim(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Concatenate the blocks of one axis's ranks along ``dim``."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _gather(out, moved, group)
    return out.movedim(0, dim).contiguous()


def gather_leaf(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``block`` under ``spec``: one
    all-gather an axis the spec names, the innermost axis of a tuple
    first. ``block`` itself where nothing of it is split."""
    lead = block.dim() - len(spec)
    x = block
    for d, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            if axes_size(mesh, (a,)) > 1:
                x = _gather_dim(x, lead + d, mesh, a)
    return x


# ---------------------------------------------------------------------------
# one axis's blocks along a dim (tensor-parallel compute over "model")
# ---------------------------------------------------------------------------

def range_sizes(n: int, size: int) -> list:
    """The lengths of the ``row_range`` blocks of ``n`` over ``size``
    ranks, in rank order."""
    return [hi - lo for lo, hi in (row_range(n, size, r)
                                   for r in range(size))]


def all_gather_dim(x: torch.Tensor, mesh, axis: str, dim: int,
                   sizes: Sequence[int]) -> torch.Tensor:
    """Concatenate along ``dim``, in rank order, the blocks of the ranks of
    one mesh axis (the ranks that share this rank's place on the other
    axes), on every one of them. ``sizes``: every rank's block length
    along ``dim`` (``range_sizes(n, size)`` for ``row_range`` blocks).
    The blocks are padded to the longest for one
    ``all_gather_into_tensor``. ``x`` itself where the axis has one
    rank."""
    size = axes_size(mesh, (axis,))
    if size == 1:
        return x
    group = mesh.get_group(axis)
    moved = x.movedim(dim, 0)
    sizes = [int(s) for s in sizes]
    if len(sizes) != size or sizes[dist.get_rank(group)] != moved.shape[0]:
        raise ValueError(f"all_gather_dim: block sizes {sizes} over the "
                         f"{size} ranks of {axis!r}; this rank holds "
                         f"{moved.shape[0]}")
    pad = max(sizes)
    if moved.shape[0] == pad:
        block = moved.contiguous()
    else:
        block = moved.new_zeros((pad,) + tuple(moved.shape[1:]))
        block[:moved.shape[0]] = moved
    out = _gather(block.new_empty((size * pad,) + tuple(block.shape[1:])),
                  block, group, "all_gather_dim")
    if any(s != pad for s in sizes):
        out = torch.cat([out[r * pad:r * pad + s]
                         for r, s in enumerate(sizes)])
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int,
                    sizes: Sequence[int]) -> torch.Tensor:
    group = mesh.get_group(axis)
    buf = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=group)
    _count("reduce_scatter_dim", buf)
    lo, hi = _span(sizes, dist.get_rank(group))
    return buf.narrow(dim, lo, hi - lo).contiguous()


def reduce_scatter_dim(x: torch.Tensor, mesh, axis: str,
                       dim: int) -> torch.Tensor:
    """Sum every rank's whole partial ``x`` over one mesh axis and keep
    this rank's ``row_range`` block of ``dim`` (a tensor of its own):
    an all-reduce of a copy, then a slice, on gloo and NCCL alike. ``x``
    itself where the axis has one rank."""
    size = axes_size(mesh, (axis,))
    if size == 1:
        return x
    return _reduce_scatter(x, mesh, axis, dim,
                           range_sizes(x.shape[dim], size))


def _span(sizes: Sequence[int], rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s block [lo, hi) of blocks of ``sizes``, rank order."""
    lo = sum(int(s) for s in sizes[:rank])
    return lo, lo + int(sizes[rank])


def _all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    buf = x.clone(memory_format=torch.contiguous_format)
    return all_reduce_tiers(buf, mesh, (axis,))


def _block(x: torch.Tensor, mesh, axis: str, dim: int,
           sizes: Sequence[int]) -> torch.Tensor:
    lo, hi = _span(sizes, dist.get_rank(mesh.get_group(axis)))
    return x.narrow(dim, lo, hi - lo).contiguous()


# ---------------------------------------------------------------------------
# the block path's collectives as autograd Functions (grad- and vmap-aware)
# ---------------------------------------------------------------------------

def _batched(fn, in_dims, x, *args):
    """A ``vmap`` rule: ``fn`` once on the whole batch, the vmapped dim
    moved to the front (every dim argument counts from the end)."""
    if in_dims[0] is None:
        return fn(x, *args), None
    return fn(x.movedim(in_dims[0], 0), *args), 0


class _Gather(torch.autograd.Function):
    """``all_gather_dim``; backward: the partial cotangents summed, this
    rank's block (``partial``), or this rank's block of the whole
    cotangent."""

    @staticmethod
    def forward(x, mesh, axis, dim, sizes, partial):
        return all_gather_dim(x, mesh, axis, dim, sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:5]
        ctx.partial = inputs[5]

    @staticmethod
    def backward(ctx, g):
        fn = _ReduceScatter if ctx.partial else _Block
        return (fn.apply(g, *ctx.args),) + (None,) * 5

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis, dim, sizes, partial):
        return _batched(all_gather_dim, in_dims, x, mesh, axis, dim, sizes)


class _ReduceScatter(torch.autograd.Function):
    """Every rank's partial summed, this rank's block of ``sizes`` kept;
    backward: the blocks' cotangents all-gathered (every rank's partial
    gets the whole cotangent)."""

    @staticmethod
    def forward(x, mesh, axis, dim, sizes):
        return _reduce_scatter(x, mesh, axis, dim, sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return (_Gather.apply(g, *ctx.args, True),) + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis, dim, sizes):
        return _batched(_reduce_scatter, in_dims, x, mesh, axis, dim, sizes)


class _Block(torch.autograd.Function):
    """This rank's block of ``sizes`` of a tensor every rank holds whole
    alike; backward: the blocks' cotangents all-gathered."""

    @staticmethod
    def forward(x, mesh, axis, dim, sizes):
        return _block(x, mesh, axis, dim, sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return (_Gather.apply(g, *ctx.args, False),) + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis, dim, sizes):
        return _batched(_block, in_dims, x, mesh, axis, dim, sizes)


class _AllReduce(torch.autograd.Function):
    """The sum over one axis's ranks; backward: the identity where every
    rank reads the sum alike (``enter``), an all-reduce where each reads
    it for its own block (``partial``)."""

    @staticmethod
    def forward(x, mesh, axis, partial):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axis, ctx.partial = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _AllReduce.apply(g, ctx.mesh, ctx.axis, True), None, \
                None, None
        return _Enter.apply(g, ctx.mesh, ctx.axis), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis, partial):
        return _batched(_all_reduce, in_dims, x, mesh, axis)


class _Enter(torch.autograd.Function):
    """The identity, where a whole tensor every rank holds alike enters
    the rank's column blocks; backward: the partial cotangents summed
    (Megatron's ``f``)."""

    @staticmethod
    def forward(x, mesh, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh, ctx.axis = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return _AllReduce.apply(g, ctx.mesh, ctx.axis, False), None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axis):
        return x.view_as(x), in_dims[0]


def _from_end(x: torch.Tensor, dim: int) -> int:
    return dim - x.dim() if dim >= 0 else dim


def gather_dim(x: torch.Tensor, mesh, axis: str, dim: int,
               sizes: Sequence[int], partial: bool = False) -> torch.Tensor:
    """``all_gather_dim``, differentiable: ``partial`` where the gathered
    tensor's readers on each rank are its column blocks (their cotangents
    are summed and scattered back), else its readers compute alike on
    every rank (each takes its block of the cotangent)."""
    if axes_size(mesh, (axis,)) == 1:
        return x
    return _Gather.apply(x, mesh, axis, _from_end(x, dim),
                         tuple(int(s) for s in sizes), partial)


def reduce_scatter_sum(x: torch.Tensor, mesh, axis: str, dim: int,
                       sizes: Sequence[int]) -> torch.Tensor:
    """``reduce_scatter_dim`` into the blocks of ``sizes``, differentiable
    (backward: the blocks' cotangents all-gathered)."""
    if axes_size(mesh, (axis,)) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis, _from_end(x, dim),
                                tuple(int(s) for s in sizes))


def block_dim(x: torch.Tensor, mesh, axis: str, dim: int,
              sizes: Sequence[int]) -> torch.Tensor:
    """This rank's block of ``sizes`` along ``dim`` (a tensor of its own)
    of ``x``, which every rank of ``axis`` holds whole alike;
    differentiable (backward: the blocks' cotangents all-gathered)."""
    if axes_size(mesh, (axis,)) == 1:
        return x
    return _Block.apply(x, mesh, axis, _from_end(x, dim),
                        tuple(int(s) for s in sizes))


def all_reduce_sum(x: torch.Tensor, mesh, axis: str,
                   partial: bool = False) -> torch.Tensor:
    """The sum of ``x`` over one axis's ranks (a tensor of its own),
    differentiable: the backward is the identity where every rank reads
    the sum alike, and an all-reduce where each rank reads it for its own
    block of the work (``partial``: a norm's sum of squares over a split
    dim)."""
    if axes_size(mesh, (axis,)) == 1:
        return x
    return _AllReduce.apply(x, mesh, axis, partial)


def enter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``, which every rank of ``axis`` holds alike, as the input of
    the rank's column blocks: the identity forward, the partial
    cotangents all-reduced backward."""
    if axes_size(mesh, (axis,)) == 1:
        return x
    return _Enter.apply(x, mesh, axis)
