"""MeshBackend — the round's clients spread over the ranks of a mesh.

The port of ``repro.core.engine.backends.mesh``. One process a device
(``torch.distributed``); the mesh is a DeviceMesh (``launch.mesh.make_mesh``)
with a ``"data"`` axis, an optional ``"pod"`` axis, and every other axis of
size 1. Every rank draws the same cohort from the same numpy seed, so
sampling and K_r agree on every rank; placement keeps what this rank
trains, cut on the host before the copy.

``strategy="parallel"`` (cross-device FL simulation): the client rows
spread over the ``("pod", "data")`` or ``("data",)`` axes. Placement keeps
this rank's contiguous block of the cohort's rows
(``collectives.row_range``: a block may be one row longer than another, so
the cohort need not divide among the ranks). Each rank runs the vmapped
client update on its rows, and the client-axis reductions are the
per-rank kernel plus a collective:

  * ``kernel`` -> ``ops.fedavg_reduce_tree_sharded``;
  * ``mean`` -> the weighted sum of this rank's rows, all-reduced (the
    contraction GSPMD makes of the reference's mean);
  * ``median``, ``trimmed_mean`` (or any other aggregator) -> the client
    stack all-gathered, then the aggregator on every rank;
  * a compressed uplink is bound to the mesh (``Transport.with_mesh``): its
    reduce runs the sharded kernel, and its error-feedback sum is
    all-reduced; per-client error feedback (``Transport.ef_slots``) gives
    each rank the slots of its own rows; the int8 downlink's decode-apply
    runs the sharded decode-apply (``bind_downlink``).

``strategy="sequential"`` (cross-silo FL): ``groups`` client groups, the
clients of a group one after another, each client's K steps with one
parameter set in memory. The reference vmaps the groups and scans the
clients (``mesh.py:237-401``); the port loops over both with the unvmapped
client update (one client in memory at a time):

  * the groups spread over the ``"pod"`` ranks in contiguous blocks
    (hierarchical FL); with no ``"pod"`` axis every rank runs every group,
    and a pod left without a group is refused;
  * each client's local batch dim ``b`` is split over the ``"data"`` ranks
    where it divides among them (the reference's ``_batch_spec``), and
    replicated otherwise; where it is split, each local step's gradients
    are all-reduced over ``"data"``, each rank weighted by its share of
    the loss's denominator (its rows, or its next-token mask tokens), so
    every data rank takes the same step;
  * ``mean`` and ``kernel`` stream a running weighted sum in ``acc_dtype``
    (no (N, ...) client stack); ``median`` and ``trimmed_mean`` stack the
    clients' params, all-gathered by rows over ``"pod"``;
  * a compressed uplink encodes each client's delta (plus its error
    feedback: the aggregate residual, or the client's own slot) and folds
    the decoded payload into an f32 sum; aggregate feedback streams the
    true sum too, and the residual is true - hat;
  * the group sums are all-reduced over ``"pod"``
    (``collectives.all_reduce_axis``, ``reduce="grouped"`` honoured);
  * a downlink reconstructs the broadcast once a round at the core's top,
    through the single-device decode-apply kernel on every rank.

An axis of one rank runs no collective in the sequential core, so on a
world of one rank it is the reference's sequential core on a 1x1 mesh.

Both strategies run the server step, the downlink encode and the codec
state replicated on every rank: the all-reduce hands every rank the same
sum, so their inputs agree. First and last losses are gathered to every
rank in client order. ``reduce="grouped"`` turns each all-reduce into one
per client axis, innermost first (within each pod, then across pods). On a
mesh of one rank the parallel strategy gives ``LocalBackend``'s result bit
for bit.

Sharded parameters (``param_specs``, the spec tree of
``distributed.sharding.param_pspecs``), on either strategy: sharded at
rest, gathered at use. Every params-shaped tree that lives across rounds
holds only this rank's block of each leaf (``ParamLayout``): the params,
the server optimizer's state, the codec's residuals and per-client slots,
the downlink's reference and residual. A ``"model"`` axis of any size is
accepted: the client axes stay ``("pod", "data")`` or ``("data",)``; the
``"model"`` ranks of one client row compute the same rows, alike bit for
bit, unless the round core is given ``model_grads`` (below). The
sequential core works on blocks: each local step gathers
the whole params for the forward and backward and updates its block from
the block of the gradients; the weighted sums, the server step and the
robust aggregators run on blocks; the codecs gather each leaf whose
encoding reads the whole of it (``Transport.with_layout``). The parallel
core gathers the params and state at the round's top (its client stack is
whole on every rank anyway) and keeps blocks of what it returns. Either
way a sharded run equals the same world's replicated run bit for bit.
What reads params outside the round core gets whole leaves
(``gather_state``: eval, the model store's snapshot and checkpoint, the
trainer's ``params``), so a checkpoint does not depend on the layout.
Registry keys use the whole leaves' shapes (``signature_args``).

Streaming cohorts (``make_slab_cores``, the parallel strategy): each slab
is placed like a dense round's cohort (``place_slab``: this rank's block
of the slab's rows and weights), runs the parallel core's client update
and aggregation on those rows and folds the all-reduced partials into
sums every rank holds whole. A slab smaller than the world leaves some
ranks without a row: such a rank computes nothing, adds zero partials and
joins every collective in the same order as the others (its sharded
kernels launch nothing). Per-client slots are cut to the rank's rows of
each slab and gathered back once a round (``collect_transport_state``
with the rows' cohort positions). Under ``param_specs`` each slab's core
gathers the params at its top; the finalize keeps blocks.

Fleet sub-meshes (``fleet_slices``): ``carve_submeshes`` cuts the rank
grid into disjoint DeviceMeshes, built in the same order on every rank;
one backend a sweep point, cycled over the slices. A rank runs only the
points of the slice that holds it (``launch.fleet``).

The async engine (``core.engine.async_buffer``) runs on a MeshBackend as
the reference's does: unsharded, the same event loop on every rank, the
backend only placing (and, under ``param_specs``, sharding at rest) the
params.

Tensor-parallel training (``make_round_core(model_grads=...)``, built by
``distributed.make_fed_train_step(mesh=, act_spec=...)``): the loss runs on
a ``ModelRank``'s blocks (``transformer.loss_lm(tp=)``), so each
``"model"`` rank of a client row computes its share of every layer,
forward and backward. Both cores take the rank's grad hook
(``ModelGrads.hook``: the partial gradients summed over ``"model"`` each
local step; under the parallel strategy inside the vmap) and put each
client's blocked leaves back together from their owners after its K
steps (``ModelGrads.gather``: on the parallel core's client stack,
outside the vmap; on each sequential client's result). Under
``param_specs`` the sequential core still gathers the whole params each
step and cuts the rank's compute blocks from them; its hook gathers the
blocked gradients too, since ``part`` cuts rest blocks. Every rank ends
each step with the same params.

Differences from the reference: where it sends a cohort that does not
divide among the shards through the unsharded kernel (``mesh.py:227-229``,
``transport.py:334-335``), the port splits the cohort unevenly; the sums
agree within the 1e-6 the reference allows between groupings. The groups
are looped, not vmapped, and sums are re-associated (ROADMAP Known
differences 16). Tensor-parallel training computes by blocks of ranks,
not under GSPMD, and sums partial gradients in another order (Known
differences 22); without ``model_grads`` a rank gathers whole leaves
rather than running column- and row-parallel matmuls (Known differences
17).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.engine.aggregators import (LINEAR_AGGREGATORS,
                                                 get_aggregator)
from repro_torch.core.engine.backends.base import ExecutionBackend, LossFn
from repro_torch.core.engine.backends.local import (
    encode_broadcast, make_parallel_round_core, make_parallel_slab_cores)
from repro_torch.core.engine.client import client_update
from repro_torch.core.engine.transport import Q8_PLANES
from repro_torch.data.pipeline import (BucketBatch, SlabBatch,
                                       slice_batch_rows, slice_clients)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.collectives import (all_gather_axis,
                                             all_gather_rows,
                                             all_reduce_axis,
                                             all_reduce_tiers, axes_size,
                                             axis_range, block_of,
                                             gather_leaf, register_span,
                                             rows_of)
from repro_torch.optim import tree_leaves, tree_map

STRATEGIES = ("parallel", "sequential")
REDUCES = ("flat", "grouped")


def carve_grid(ranks: np.ndarray, n: int) -> List[np.ndarray]:
    """The rank grid ``ranks`` (one entry a mesh position) cut along its
    largest axis (the first of equal ones) into ``g`` contiguous slices,
    ``g`` the largest divisor of that axis's size with ``g <= n``; every
    slice keeps all the axes. One slice, the grid itself, where ``g`` is
    1 (the reference's ``carve_submeshes`` on a device grid,
    ``mesh.py:51-73``)."""
    shape = ranks.shape
    axis = max(range(len(shape)), key=lambda i: shape[i])
    size = shape[axis]
    g = max((d for d in range(1, min(n, size) + 1) if size % d == 0),
            default=1)
    if g <= 1:
        return [ranks]
    step = size // g
    out = []
    for i in range(g):
        idx = [slice(None)] * len(shape)
        idx[axis] = slice(i * step, (i + 1) * step)
        out.append(ranks[tuple(idx)])
    return out


def carve_submeshes(mesh, n: int):
    """Up to ``n`` disjoint sub-meshes of the DeviceMesh ``mesh`` for fleet
    packing: ``carve_grid`` on its rank grid, each slice a DeviceMesh over
    those ranks with the same axis names. A mesh that does not split (one
    rank, or ``n`` 1) returns ``[mesh]``; the caller cycles points over
    what came back.

    Building a sub-group is collective over the whole world: every rank
    must call this with the same arguments, and builds every slice (and
    one group over each slice's ranks, for collectives over all its client
    axes) in the same order, its own slice or not."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    grids = carve_grid(mesh.mesh.cpu().numpy(), n)
    if len(grids) == 1:
        return [mesh]
    subs = []
    for grid in grids:
        sub = DeviceMesh(mesh.device_type, torch.as_tensor(grid),
                         mesh_dim_names=mesh.mesh_dim_names)
        register_span(sub, dist.new_group(sorted(grid.reshape(-1).tolist())))
        subs.append(sub)
    return subs


class ParamLayout:
    """The one place that knows the blocks of a sharded params tree on this
    rank: each leaf's spec (``tree_leaves`` order), the whole leaf's shape,
    this rank's block shape and the mesh. ``shapes`` come from the specs
    (``param_pspecs`` records them) or from the first whole tree placed
    (``learn``).

    A leaf is whole or this rank's block, told apart by its trailing dims
    (or, flattened, its size): a split dim makes the block smaller, and
    where nothing is split the two are one. ``block`` and ``gather``
    return a leaf of the form they make unchanged; a leaf of neither shape
    is refused."""

    def __init__(self, specs, mesh):
        self.specs = tree_leaves(specs)
        self.mesh = mesh
        it = iter(range(len(self.specs)))
        self._index = tree_map(lambda _: next(it), specs)
        shapes = [getattr(s, "shape", None) for s in self.specs]
        self.shapes = self.block_shapes = None
        if not any(x is None for x in shapes):
            self._set_shapes(shapes)

    def _set_shapes(self, shapes) -> None:
        # imported here: ``repro_torch.distributed`` imports this module
        from repro_torch.distributed.sharding import MeshShape, block_shape
        grid = MeshShape.of(self.mesh)
        self.shapes = [tuple(x) for x in shapes]
        self.block_shapes = [block_shape(x, spec, grid)
                             for x, spec in zip(self.shapes, self.specs)]

    def learn(self, tree) -> None:
        if self.shapes is None:
            self._set_shapes([x.shape for x in tree_leaves(tree)])

    def is_whole(self, i: int, x: torch.Tensor) -> bool:
        """Whether ``x`` (trailing dims; leading dims are per-client slots)
        is leaf ``i`` whole rather than this rank's block of it."""
        if self.shapes is None:          # nothing placed yet: whole
            return True
        whole, part = self.shapes[i], self.block_shapes[i]
        tail = tuple(x.shape[max(x.dim() - len(whole), 0):])
        if tail == whole:
            return True
        if tail == part:
            return False
        raise ValueError(f"param leaf {i}: shape {tuple(x.shape)} is "
                         f"neither the whole leaf {whole} nor this rank's "
                         f"block {part}")

    def is_whole_flat(self, i: int, flat: torch.Tensor) -> bool:
        """``is_whole`` for a flattened leaf (a q8 plane, a payload's int8
        plane), by its size."""
        whole = math.prod(self.shapes[i])
        if flat.numel() == whole:
            return True
        if flat.numel() == math.prod(self.block_shapes[i]):
            return False
        raise ValueError(f"param leaf {i}: {flat.numel()} elements are "
                         f"neither the whole leaf {self.shapes[i]} nor this "
                         f"rank's block {self.block_shapes[i]}")

    def block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``i``; a block passes through."""
        if not self.is_whole(i, x):
            return x
        return block_of(x, self.specs[i], self.mesh)

    def gather(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole; a whole leaf passes through."""
        if self.is_whole(i, x):
            return x
        return gather_leaf(x, self.specs[i], self.mesh)

    def block_flat(self, i: int, flat: torch.Tensor) -> torch.Tensor:
        """A flattened leaf -> its block, flattened; a flattened block
        passes through."""
        if not self.is_whole_flat(i, flat):
            return flat
        return self.block(i, flat.reshape(self.shapes[i])).reshape(-1)

    def gather_flat(self, i: int, flat: torch.Tensor) -> torch.Tensor:
        """A flattened block -> the flattened whole leaf."""
        if self.is_whole_flat(i, flat):
            return flat
        return self.gather(i, flat.reshape(self.block_shapes[i])
                           ).reshape(-1)

    def map(self, tree, fn, flat_fn):
        """Apply ``fn(i, leaf)`` to every params-shaped part of ``tree``
        (the params, a server state's ``m``/``v``, a codec's residual or
        per-client slots) and ``flat_fn(i, plane)`` to a q8 store leaf's
        int8 planes, leaving everything else (step counts, scales, batches,
        ``()``) as it is. A dict that shares some but not all of a params
        level's keys, or a container where a param leaf belongs, is
        refused."""
        return _map_params_like(tree, self._index, fn, flat_fn)

    def to_blocks(self, tree):
        return self.map(tree, self.block, self.block_flat)

    def to_whole(self, tree):
        return self.map(tree, self.gather, self.gather_flat)


def _map_params_like(tree, index, fn, flat_fn):
    if isinstance(index, dict):
        if isinstance(tree, dict):
            if tree.keys() == index.keys():
                return {k: _map_params_like(tree[k], index[k], fn, flat_fn)
                        for k in tree}
            if tree.keys() & index.keys():
                raise ValueError(
                    f"a params-shaped tree with keys {sorted(tree)} where "
                    f"the params have {sorted(index)}")
            return {k: _map_params_like(v, index, fn, flat_fn)
                    for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(_map_params_like(v, index, fn, flat_fn)
                              for v in tree)
        return tree
    if isinstance(tree, torch.Tensor):
        return fn(index, tree)
    if isinstance(tree, dict) and "q8_q" in tree:
        return {k: (flat_fn(index, v) if k in Q8_PLANES else v)
                for k, v in tree.items()}
    if isinstance(tree, (dict, tuple, list)):
        raise ValueError(f"a {type(tree).__name__} where param leaf {index} "
                         f"belongs")
    return tree


def _chain(first, then):
    """Two ``client_update`` grad hooks, one after the other (``then``
    may be None)."""
    if then is None:
        return first

    def hook(grads, loss, batch):
        return then(*first(grads, loss, batch), batch)
    return hook


def loss_share(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """This rank's share of a split local batch's loss denominator: the
    next-token mask tokens where the batch carries a ``mask`` (the LM
    loss counts ``mask[:, 1:]``), else its rows (the losses are means over
    rows, or over rows x positions)."""
    mask = batch.get("mask")
    if mask is not None:
        return mask[:, 1:].to(torch.float32).sum()
    x = next(iter(batch.values()))
    return torch.tensor(float(x.shape[0]), device=x.device)


class MeshBackend(ExecutionBackend):
    name = "mesh"

    def __init__(self, mesh, *, strategy: str = "parallel", groups: int = 1,
                 acc_dtype: torch.dtype = torch.float32,
                 reduce: str = "flat", param_specs=None, device=None):
        """``mesh``: a DeviceMesh over every rank, with a ``"data"`` axis,
        an optional ``"pod"`` axis, an optional ``"model"`` axis of any
        size, and any other axis of size 1; None builds the same cores on
        ``device`` alone (no collective, plain placement), as the
        reference's ``mesh=None``.
        ``strategy``: ``"parallel"`` or ``"sequential"``. ``groups``: the
        sequential strategy's client groups (at least one a pod rank).
        ``acc_dtype``: the sequential streaming sum's dtype (f32 keeps
        ``LocalBackend``'s numbers; bf16 halves it). ``reduce``:
        ``"flat"`` for one all-reduce over all client axes, ``"grouped"``
        for one per axis, innermost first. ``param_specs``: the params'
        spec tree (``distributed.sharding.param_pspecs``): each rank holds
        its block of every leaf."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; known: "
                             f"{STRATEGIES}")
        if reduce not in REDUCES:
            raise ValueError(f"unknown reduce {reduce!r}; known: {REDUCES}")
        names = tuple(mesh.mesh_dim_names) if mesh is not None else ("data",)
        client_axes = ("pod", "data") if "pod" in names else ("data",)
        extra = [a for a in names if a not in client_axes + ("model",)
                 and axes_size(mesh, (a,)) > 1]
        if "data" not in names or extra:
            raise ValueError(f"the mesh {names} needs a 'data' axis, and "
                             f"every axis but 'pod', 'data' and 'model' of "
                             f"size 1")
        self.mesh = mesh
        self.strategy = strategy
        self.groups = max(int(groups), 1)
        self.acc_dtype = acc_dtype
        self.client_axes = client_axes
        self.reduce = reduce
        # innermost axis first: ("pod", "data") -> (("data",), ("pod",))
        self.reduce_tiers = (tuple((a,) for a in reversed(client_axes))
                             if reduce == "grouped" else None)
        if strategy == "sequential":
            pods = axes_size(mesh, ("pod",))
            if pods > 1 and param_specs is not None and any(
                    "pod" in (e if isinstance(e, tuple) else (e,))
                    for spec in tree_leaves(param_specs) for e in spec):
                raise ValueError(
                    "param_specs shard over 'pod', but the sequential "
                    "strategy's pods run different client groups: shard "
                    "over 'pod' with the parallel strategy")
            if self.groups < pods:
                raise ValueError(
                    f"groups={self.groups} over {pods} 'pod' ranks leaves a "
                    f"pod without a group")
        # whether placement split each client's batch over "data" (set by
        # the sequential placement, read by its core)
        self._b_split = None
        self.param_specs = param_specs
        self.layout = (ParamLayout(param_specs, mesh)
                       if param_specs is not None else None)
        self.device = resolve_device(mesh.device_type if mesh is not None
                                     else device)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())

    def program_signature(self) -> tuple:
        sig = ("mesh", self.strategy, self.groups,
               str(self.acc_dtype).replace("torch.", ""), self.reduce)
        if self.layout is not None:      # the layout shapes the program
            sig += ("specs",) + tuple(self.layout.specs)
        return sig

    # ------------------------------------------------------------------
    # round core
    # ------------------------------------------------------------------
    def make_round_core(self, loss_fn: LossFn, *, aggregator: str = "mean",
                        trim_fraction: float = 0.1, server=None,
                        server_lr: float = 1.0, transport=None,
                        downlink=None, model_grads=None):
        """The round core (``make_parallel_round_core``'s contract).
        ``model_grads``: the tensor-parallel train step's gradients on the
        ``"model"`` ranks (``distributed.sharding.ModelGrads``, for a
        ``loss_fn`` on a ``ModelRank``): each local step's partial
        gradients summed over ``"model"`` (``client_update``'s grad hook),
        and the blocked leaves of each client's result put back together
        from their owners once after the K steps."""
        if self.strategy == "sequential":
            return self._make_sequential_core(
                loss_fn, aggregator, trim_fraction, server, server_lr,
                transport, downlink, model_grads)
        whole, blocks = self.gather_state, self.constrain_update
        core = self._make_parallel_core(loss_fn, aggregator, trim_fraction,
                                        self._block_server(server),
                                        server_lr, transport, downlink,
                                        model_grads)
        if self.layout is None:
            return core
        # per-client slots stay whole through the core: each rank holds
        # other clients' rows (``collect_transport_state`` cuts blocks)
        t_blocks = (blocks if transport is None or not transport.ef_slots
                    else (lambda t: t))

        def sharded_core(params, batches, weights, eta, server_state,
                         t_state=(), d_state=()):
            # the params and codec state gathered at the round's top (the
            # client stack is whole on every rank); blocks of what lives on
            out = core(whole(params), batches, weights, eta, server_state,
                       whole(t_state), whole(d_state))
            return (blocks(out[0]), *out[1:4], t_blocks(out[4]),
                    blocks(out[5]), out[6])

        return sharded_core

    def _block_server(self, server):
        """Under ``param_specs``, the server step on this rank's blocks of
        the params and the aggregate, and of its own state; else
        ``server``."""
        if self.layout is None or server is None:
            return server
        step, blocks = server.step, self.constrain_update
        return server._replace(step=lambda p, agg, state, lr: step(
            blocks(p), blocks(agg), state, lr))

    def _make_parallel_core(self, loss_fn, aggregator, trim_fraction,
                            server, server_lr, transport, downlink,
                            model_grads=None):
        if self.mesh is None:
            return make_parallel_round_core(
                loss_fn, get_aggregator(aggregator,
                                        trim_fraction=trim_fraction),
                server, server_lr, transport=transport, downlink=downlink)
        if transport is not None:
            # a bound copy: reduce() runs the client-sharded kernels
            transport = transport.with_mesh(self.mesh, self.client_axes,
                                            self.reduce_tiers)
        tp = {} if model_grads is None else dict(
            grad_hook=model_grads.hook(), collect=model_grads.gather)
        core = make_parallel_round_core(
            loss_fn, self._resolve_aggregator(aggregator, trim_fraction),
            server, server_lr, transport=transport, downlink=downlink, **tp)
        mesh, axes = self.mesh, self.client_axes

        def mesh_core(params, batches, weights, eta, server_state,
                      t_state=(), d_state=()):
            out = core(params, batches, weights, eta, server_state, t_state,
                       d_state)
            # every rank's (first, last) losses, in client order
            losses = all_gather_rows(torch.stack(out[1:3], dim=1), mesh,
                                     axes)
            return (out[0], losses[:, 0], losses[:, 1], *out[3:])

        return mesh_core

    def _resolve_aggregator(self, name, trim_fraction: float):
        mesh, axes, tiers = self.mesh, self.client_axes, self.reduce_tiers
        if name == "kernel":
            return lambda cp, w: kops.fedavg_reduce_tree_sharded(
                cp, w, mesh=mesh, client_axes=axes, reduce_tiers=tiers)
        if name == "mean":
            def sharded_mean(cp, w):
                w32 = w.to(torch.float32)
                return tree_map(lambda x: all_reduce_tiers(
                    torch.tensordot(w32, x.to(torch.float32), dims=1), mesh,
                    axes, tiers).to(x.dtype), cp)

            return sharded_mean
        agg = get_aggregator(name, trim_fraction=trim_fraction)

        def gathered(cp, w):       # robust aggregators see every client
            gather = lambda x: all_gather_rows(x, mesh, axes)
            return agg(tree_map(gather, cp), gather(w))

        return gathered

    # ------------------------------------------------------------------
    # the sequential strategy
    # ------------------------------------------------------------------
    def _data_hook(self):
        """The ``client_update`` gradient hook of a batch split over
        ``"data"``: each rank's gradients and loss weighted by its share
        of the denominator, all-reduced (None where ``b`` is not split)."""
        if axes_size(self.mesh, ("data",)) == 1:
            return None
        if self._b_split is None:
            raise ValueError(
                "the sequential strategy's batches must be placed by "
                "MeshBackend.place_batches or place_bucket, which split "
                "each client's batch over 'data'")
        if not self._b_split:
            return None
        mesh = self.mesh

        def hook(grads, loss, batch):
            m = loss_share(batch)
            tot = all_reduce_axis(torch.stack([m, m * loss.detach().to(
                torch.float32)]), mesh, "data")
            share = m / tot[0]
            grads = tree_map(lambda g: all_reduce_axis(
                g.mul_(share.to(g.dtype)), mesh, "data"), grads)
            return grads, (tot[1] / tot[0]).to(loss.dtype)

        return hook

    def _make_sequential_core(self, loss_fn, aggregator, trim_fraction,
                              server, server_lr, transport, downlink,
                              model_grads=None):
        """round_core with ``make_parallel_round_core``'s contract, the
        clients one at a time (``mesh.py:115-153, 188-401``)."""
        if transport is not None and transport.name == "none":
            transport = None          # the identity codec: the plain core
        layout = self.layout
        if transport is not None and layout is not None:
            transport = transport.with_layout(layout)   # whole-leaf encodes
        # a sharded client gathers the whole params for each step's forward
        # and backward and updates its block from the gradients' block
        whole = part = None
        if layout is not None:
            whole = lambda tree: layout.map(tree, layout.gather, None)
            part = lambda tree: layout.map(tree, layout.block, None)
        stream = aggregator in LINEAR_AGGREGATORS
        agg = None if stream else get_aggregator(
            aggregator, trim_fraction=trim_fraction)
        mesh, groups, acc_dtype = self.mesh, self.groups, self.acc_dtype
        pod_tiers = (("pod",),) if self.reduce == "grouped" else None
        ef = transport is not None and transport.error_feedback
        per_client = ef and bool(transport.ef_slots)
        f32 = torch.float32

        def pod_sum(tree):
            return tree_map(lambda x: all_reduce_axis(x, mesh, "pod",
                                                      pod_tiers), tree)

        def zeros(params, dtype):
            return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                                  device=p.device), params)

        def fold(total, part):
            """Add a finished group's sum into the round's (the first
            group's sum is the round's)."""
            if total is None:
                return part
            return tree_map(lambda a, b: a.add_(b), total, part)

        def round_core(params, batches, weights, eta, server_state,
                       t_state=(), d_state=()):
            level = None
            if downlink is not None:
                # one reconstruction a round, at the core's top
                _, _, params, d_state, level = encode_broadcast(
                    downlink, params, d_state)
            n = int(weights.shape[0])          # this pod's clients
            g_lo, g_hi = axis_range(mesh, "pod", groups)
            if n % (g_hi - g_lo):
                raise ValueError(f"{n} clients not divisible into "
                                 f"{g_hi - g_lo} groups")
            ng = n // (g_hi - g_lo)
            hook = self._data_hook()
            if model_grads is not None:
                # the "model" ranks' partials summed first (under
                # param_specs the blocked spans gathered too: ``part`` cuts
                # rest blocks), then the "data" ranks' shares
                hook = _chain(model_grads.hook(gather=layout is not None),
                              hook)
            collect = (model_grads.gather if model_grads is not None and
                       layout is None else (lambda p: p))
            firsts, lasts = [], []

            def client(i):
                res = client_update(loss_fn, params, {
                    k: v[i] for k, v in batches.items()}, eta, hook,
                    whole=whole, part=part)
                firsts.append(res.first_loss)
                lasts.append(res.last_loss)
                return collect(res.params)

            new_t = t_state
            if transport is None and stream:
                total = None
                for g in range(0, n, ng):
                    acc = zeros(params, acc_dtype)
                    for i in range(g, g + ng):
                        w = weights[i].to(acc_dtype)
                        tree_map(lambda a, c: a.add_(w * c.to(acc_dtype)),
                                 acc, client(i))
                    total = fold(total, acc)
                aggregate = tree_map(lambda p, a: a.to(p.dtype), params,
                                     pod_sum(total))
            elif transport is None:
                # robust aggregators see every client: the stack
                stack = tree_map(lambda p: torch.empty(
                    (n,) + tuple(p.shape), dtype=p.dtype, device=p.device),
                    params)
                for i in range(n):
                    tree_map(lambda s, c: s[i].copy_(c), stack, client(i))
                gather = lambda x: all_gather_axis(x, mesh, "pod")
                aggregate = agg(tree_map(gather, stack), gather(weights))
            else:
                hat, true = None, None
                if per_client:
                    new_t = tree_map(torch.empty_like, t_state)
                for g in range(0, n, ng):
                    hat_g = zeros(params, f32)
                    true_g = zeros(params, f32) if ef and not per_client \
                        else None
                    for i in range(g, g + ng):
                        delta = tree_map(lambda c, p: c.to(f32) - p.to(f32),
                                         client(i), params)
                        if per_client:
                            tree_map(lambda d, s: d.add_(s[i]), delta,
                                     t_state)
                        elif ef:
                            tree_map(torch.Tensor.add_, delta, t_state)
                        dec = transport.decode(transport.encode(delta),
                                               like=params)
                        w32 = weights[i].to(f32)
                        tree_map(lambda a, d: a.add_(w32 * d), hat_g, dec)
                        if per_client:
                            tree_map(lambda s, d, e: torch.sub(d, e,
                                                               out=s[i]),
                                     new_t, delta, dec)
                        elif ef:
                            tree_map(lambda a, d: a.add_(w32 * d), true_g,
                                     delta)
                    hat = fold(hat, hat_g)
                    if true_g is not None:
                        true = fold(true, true_g)
                hat = pod_sum(hat)
                if true is not None:
                    new_t = tree_map(torch.sub, pod_sum(true), hat)
                aggregate = tree_map(lambda p, h: (p.to(f32) + h)
                                     .to(p.dtype), params, hat)
            new_params, server_state = server.step(params, aggregate,
                                                   server_state, server_lr)
            # every pod's (first, last) losses, in client order
            losses = all_gather_axis(
                torch.stack([torch.stack(firsts), torch.stack(lasts)],
                            dim=1), mesh, "pod")
            return (new_params, losses[:, 0], losses[:, 1], server_state,
                    new_t, d_state, level)

        return round_core

    # ------------------------------------------------------------------
    # streaming cohorts (the parallel strategy)
    # ------------------------------------------------------------------
    def make_slab_cores(self, loss_fn: LossFn, *, aggregator: str = "mean",
                        server=None, server_lr: float = 1.0, transport=None):
        """``backends.local.make_parallel_slab_cores`` over this rank's
        rows of each slab (``place_slab``): the aggregator resolved as the
        dense round's, the codec bound to the mesh, so every partial is
        all-reduced and the sums are whole on every rank; each slab's
        (first, last) losses gathered in client order. Under
        ``param_specs`` the slab core takes blocks and gathers the params
        at its top; the finalize's server step runs on blocks and it
        returns blocks of the params (its residual stays whole)."""
        if self.strategy == "sequential":
            raise ValueError(
                "cohort_chunk requires the parallel strategy: the grouped "
                "sequential scan already streams clients without a slab "
                "decomposition")
        if self.mesh is None:
            return make_parallel_slab_cores(
                loss_fn, get_aggregator(aggregator), server, server_lr,
                transport=transport)
        whole, blocks = self.gather_state, self.constrain_update
        if transport is not None:
            transport = transport.with_mesh(self.mesh, self.client_axes,
                                            self.reduce_tiers)
        slab_core, finalize_core = make_parallel_slab_cores(
            loss_fn, self._resolve_aggregator(aggregator, 0.1),
            self._block_server(server), server_lr, transport=transport)
        mesh, axes = self.mesh, self.client_axes

        def mesh_slab_core(params, batches, weights, eta, acc, ef):
            acc, first, last, ef = slab_core(whole(params), batches, weights,
                                             eta, acc, ef)
            losses = all_gather_rows(torch.stack([first, last], dim=1), mesh,
                                     axes)
            return acc, losses[:, 0], losses[:, 1], ef

        def mesh_finalize_core(params, acc, server_state):
            new_params, server_state, res = finalize_core(whole(params), acc,
                                                          server_state)
            return blocks(new_params), server_state, res

        return mesh_slab_core, mesh_finalize_core

    def place_slab(self, sb: SlabBatch) -> SlabBatch:
        """A host slab (leaves (C, K, b, ...), weights (C,)) -> this rank's
        block of its rows on the device (``collectives.row_range``; none
        where the slab has fewer rows than the client ranks), sliced
        before the copy. ``start``/``stop`` become the cohort positions of
        this rank's rows; ``ids`` stay the whole slab's. A placed slab
        passes through."""
        if self.mesh is None or not isinstance(sb.weights, np.ndarray):
            return super().place_slab(sb)
        lo, hi = rows_of(self.mesh, self.client_axes, len(sb.weights))
        return super().place_slab(dataclasses.replace(
            sb, batches={k: v[lo:hi] for k, v in sb.batches.items()},
            weights=sb.weights[lo:hi], start=sb.start + lo,
            stop=sb.start + hi))

    def fleet_slices(self, n: int):
        """One MeshBackend a packed sweep point on disjoint sub-meshes of
        this backend's mesh (``carve_submeshes``), cycled where there are
        fewer slices than points; strategy, groups, ``acc_dtype``,
        ``reduce`` and ``param_specs`` carry over, and the client axes
        follow the slice's axis names, which carving keeps. Collective:
        every rank calls it with the same ``n``."""
        if self.mesh is None:
            return [self] * n
        meshes = carve_submeshes(self.mesh, n)
        return [MeshBackend(meshes[i % len(meshes)], strategy=self.strategy,
                            groups=self.groups, acc_dtype=self.acc_dtype,
                            reduce=self.reduce, param_specs=self.param_specs)
                for i in range(n)]

    # ------------------------------------------------------------------
    # placement: this rank's clients (and, sequential, its batch rows)
    # ------------------------------------------------------------------
    def rows(self, n: int):
        """This rank's client rows [lo, hi) of an ``n``-client cohort:
        its block of the rows (parallel), or its pod's groups' clients
        (sequential)."""
        if self.strategy == "sequential":
            if n % self.groups:
                raise ValueError(f"{n} clients not divisible into "
                                 f"{self.groups} groups")
            lo, hi = axis_range(self.mesh, "pod", self.groups)
            ng = n // self.groups
            return lo * ng, hi * ng
        if self.mesh is None:
            return 0, n
        lo, hi = rows_of(self.mesh, self.client_axes, n)
        if hi == lo:
            raise ValueError(
                f"a cohort of {n} clients over "
                f"{axes_size(self.mesh, self.client_axes)} ranks leaves a "
                f"rank without a client row")
        return lo, hi

    def batch_rows(self, b: int):
        """This rank's rows [lo, hi) of each client's local batch of
        ``b`` (sequential): its share where ``b`` divides among the
        ``"data"`` ranks, else all of them."""
        size = axes_size(self.mesh, ("data",))
        self._b_split = size > 1 and b % size == 0
        return axis_range(self.mesh, "data", b) if self._b_split else (0, b)

    def place_batches(self, batches: Dict[str, object]) -> Dict[str, object]:
        """Host leaves (B, N, K, b, ...) -> this rank's clients of every
        round (and, sequential, its rows of each local batch) on the
        device; tensors are placed already and pass through."""
        out = {}
        for k, v in batches.items():
            if isinstance(v, np.ndarray):
                lo, hi = self.rows(v.shape[1])
                v = v[:, lo:hi]
                if self.strategy == "sequential":
                    lo, hi = self.batch_rows(v.shape[3])
                    v = v[:, :, :, lo:hi]
            out[k] = self.to_device(v)
        return out

    def place_weights(self, weights) -> torch.Tensor:
        """Host weights (B, N) -> this rank's clients; a tensor passes
        through."""
        if isinstance(weights, np.ndarray):
            lo, hi = self.rows(weights.shape[-1])
            weights = weights[..., lo:hi]
        return self.to_device(weights)

    def place_bucket(self, bb: BucketBatch) -> BucketBatch:
        """A host bucket (leaves (B, N, ...)) -> this rank's clients (and
        batch rows) on the device, sliced before the copy."""
        if isinstance(bb.weights, np.ndarray):
            bb = slice_clients(bb, *self.rows(bb.weights.shape[-1]))
            if self.strategy == "sequential" and bb.batches:
                b = next(iter(bb.batches.values())).shape[3]
                bb = slice_batch_rows(bb, *self.batch_rows(b))
        return super().place_bucket(bb)

    def place_params(self, params):
        """Params on the device: this rank's block of each leaf under
        ``param_specs`` (a block passes through), else whole."""
        if self.layout is None:
            return super().place_params(params)
        self.layout.learn(params)
        return self.place_state(params)

    def place_state(self, tree):
        """Every params-shaped part of ``tree`` (params, a server state, a
        codec's or the downlink's state) on the device as this rank's
        blocks; other leaves pass. Identity without ``param_specs``."""
        if self.layout is None:
            return tree
        lay, dev = self.layout, self.to_device
        return lay.map(tree, lambda i, x: dev(lay.block(i, x)),
                       lambda i, x: dev(lay.block_flat(i, x)))

    def gather_state(self, tree):
        """The inverse of ``place_state``: every params-shaped part of
        ``tree`` whole, on every rank (what reads params outside the
        round core: eval, the store's snapshot and checkpoint)."""
        if self.layout is None:
            return tree
        return self.layout.to_whole(tree)

    def constrain_update(self, tree):
        """A params-shaped tree mapped onto the specs (the reference's
        output pinning): blocks of whole leaves; a no-op for blocks and
        without ``param_specs``."""
        if self.layout is None:
            return tree
        return self.layout.to_blocks(tree)

    def signature_args(self, args):
        """A program's inputs for its registry key, params-shaped parts as
        ``meta`` stand-ins of the whole leaves: the key, and so the compile
        counts, do not depend on the layout."""
        if self.layout is None:
            return args
        lay = self.layout

        def whole(i, x):
            lead = tuple(x.shape[:x.dim() - len(lay.shapes[i])])
            return torch.empty(lead + tuple(lay.shapes[i]), dtype=x.dtype,
                               device="meta")

        return lay.map(args, whole, lambda i, x: torch.empty(
            (math.prod(lay.shapes[i]),), dtype=x.dtype, device="meta"))

    def place_transport_state(self, state, per_client: bool = False):
        """The codec's state on the device; per-client slots (leading
        cohort axis) cut to this rank's clients, whose batches it holds
        (the reference's ``_cohort_spec``); blocks under ``param_specs``."""
        if not tree_leaves(state):
            return state
        if per_client:
            if self.layout is not None:
                # every rank holds every row of its block: whole leaves
                # before the rows are cut
                state = self.gather_state(state)
            n = int(tree_leaves(state)[0].shape[0])
            lo, hi = self.rows(n)
            if (lo, hi) != (0, n):
                state = tree_map(lambda s: s[lo:hi], state)
            if self.strategy == "parallel":
                # the parallel core takes whole slots; its rows differ
                # from rank to rank, so no rank's block could be gathered
                return super().place_params(state)
        if self.layout is not None:
            return self.place_state(state)
        return super().place_params(state)

    def collect_transport_state(self, state, per_client: bool = False,
                                positions=None):
        """A bucket's per-client slots, this rank's clients, gathered back
        to the whole cohort's on every rank (other state passes); under
        ``param_specs`` this rank's blocks of the whole cohort's.
        ``positions``: the cohort position of each of this rank's rows
        (a streamed round's, one block of rows a slab); None: this rank's
        block of the cohort, in order."""
        if not per_client or not tree_leaves(state):
            return state
        if self.layout is not None:
            # rows of other ranks hold other blocks: whole leaves first
            return self.place_state(self._collect_rows(
                self.gather_state(state), positions))
        return self._collect_rows(state, positions)

    def _collect_rows(self, state, positions=None):
        if self.strategy == "sequential":
            return tree_map(lambda s: all_gather_axis(s, self.mesh, "pod"),
                            state)
        if axes_size(self.mesh, self.client_axes) == 1:
            return state
        mesh, axes = self.mesh, self.client_axes
        gathered = tree_map(lambda s: all_gather_rows(s, mesh, axes), state)
        if positions is None:
            return gathered
        pos = all_gather_rows(torch.as_tensor(
            np.asarray(positions, np.int64), device=self.device), mesh, axes)
        order = torch.argsort(pos)
        return tree_map(lambda s: s[order], gathered)

    def bind_downlink(self, codec):
        """Parallel: a bound copy, the int8 decode-apply runs the sharded
        kernel, one slice of the vector a rank. Sequential: the codec
        itself (each rank reconstructs the whole broadcast once a round),
        or, under ``param_specs``, a copy that works on this rank's
        blocks (``DownlinkCodec.with_layout``)."""
        if codec is not None and self.strategy == "sequential" and \
                self.layout is not None:
            return codec.with_layout(self.layout)
        if codec is None or self.strategy == "sequential" or \
                self.mesh is None:
            return codec
        return codec.with_mesh(self.mesh, self.client_axes,
                               self.reduce_tiers)
