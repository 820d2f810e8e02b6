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
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: collectives run by this process, by kind
counts = {"all_reduce": 0, "all_gather": 0}


def axes_size(mesh, axes) -> int:
    """Product of the named mesh axes' sizes (1 for no mesh or no axes;
    an axis the mesh lacks counts 1)."""
    if mesh is None or not axes:
        return 1
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in axes if a in names)


def client_group(mesh, axes: Sequence[str]):
    """The process group over the mesh axes ``axes`` taken together: one
    axis's group, or the default group when the axes are the whole mesh
    (every other axis of size 1)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if axes_size(mesh, axes) != mesh.size() or \
            mesh.size() != dist.get_world_size():
        raise ValueError(f"axes {axes} of the mesh "
                         f"{tuple(mesh.mesh_dim_names)} "
                         f"{tuple(mesh.shape)} must span the mesh and the "
                         f"world")
    return dist.group.WORLD


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
        counts["all_reduce"] += 1
    return x


def _gather(out: torch.Tensor, x: torch.Tensor, group) -> torch.Tensor:
    dist.all_gather_into_tensor(out, x, group=group)
    counts["all_gather"] += 1
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
