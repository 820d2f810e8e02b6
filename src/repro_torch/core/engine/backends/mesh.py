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
client update (a collective cannot run under ``torch.func.vmap``):

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

Differences from the reference: where it sends a cohort that does not
divide among the shards through the unsharded kernel (``mesh.py:227-229``,
``transport.py:334-335``), the port splits the cohort unevenly; the sums
agree within the 1e-6 the reference allows between groupings. The groups
are looped, not vmapped, and sums are re-associated (ROADMAP Known
differences 16). Not ported, and refused by name: ``param_specs`` and a
``"model"`` axis above 1 (ROADMAP A13 (b)), streaming cohorts
(``make_slab_cores``), the async engine and fleet sub-meshes
(``fleet_slices``, ``carve_submeshes``) on a mesh (A13 (c)).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.engine.aggregators import (LINEAR_AGGREGATORS,
                                                 get_aggregator)
from repro_torch.core.engine.backends.base import ExecutionBackend, LossFn
from repro_torch.core.engine.backends.local import (encode_broadcast,
                                                    make_parallel_round_core)
from repro_torch.core.engine.client import client_update
from repro_torch.data.pipeline import (BucketBatch, slice_batch_rows,
                                       slice_clients)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.collectives import (all_gather_axis,
                                             all_gather_rows,
                                             all_reduce_axis,
                                             all_reduce_tiers, axes_size,
                                             axis_range, rows_of)
from repro_torch.optim import tree_leaves, tree_map

STRATEGIES = ("parallel", "sequential")
REDUCES = ("flat", "grouped")


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
        an optional ``"pod"`` axis, and any other axis of size 1; None
        builds the same cores on ``device`` alone (no collective, plain
        placement), as the reference's ``mesh=None``.
        ``strategy``: ``"parallel"`` or ``"sequential"``. ``groups``: the
        sequential strategy's client groups (at least one a pod rank).
        ``acc_dtype``: the sequential streaming sum's dtype (f32 keeps
        ``LocalBackend``'s numbers; bf16 halves it). ``reduce``:
        ``"flat"`` for one all-reduce over all client axes, ``"grouped"``
        for one per axis, innermost first. ``param_specs`` (sharded
        parameters) is refused."""
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; known: "
                             f"{STRATEGIES}")
        if reduce not in REDUCES:
            raise ValueError(f"unknown reduce {reduce!r}; known: {REDUCES}")
        if param_specs is not None:
            raise ValueError(
                "param_specs (sharded parameters, FSDP) is not ported yet: "
                "it comes with ROADMAP A13 (b)")
        names = tuple(mesh.mesh_dim_names) if mesh is not None else ("data",)
        if "model" in names and axes_size(mesh, ("model",)) > 1:
            raise ValueError(
                f"mesh axis 'model' of size {axes_size(mesh, ('model',))}: "
                f"tensor-parallel parameters are not ported yet: they come "
                f"with ROADMAP A13 (b)")
        client_axes = ("pod", "data") if "pod" in names else ("data",)
        extra = [a for a in names
                 if a not in client_axes and axes_size(mesh, (a,)) > 1]
        if "data" not in names or extra:
            raise ValueError(f"the mesh {names} needs a 'data' axis, and "
                             f"every axis but 'pod' and 'data' of size 1")
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
            if self.groups < pods:
                raise ValueError(
                    f"groups={self.groups} over {pods} 'pod' ranks leaves a "
                    f"pod without a group")
        # whether placement split each client's batch over "data" (set by
        # the sequential placement, read by its core)
        self._b_split = None
        self.device = resolve_device(mesh.device_type if mesh is not None
                                     else device)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())

    def program_signature(self) -> tuple:
        return ("mesh", self.strategy, self.groups,
                str(self.acc_dtype).replace("torch.", ""), self.reduce)

    # ------------------------------------------------------------------
    # round core
    # ------------------------------------------------------------------
    def make_round_core(self, loss_fn: LossFn, *, aggregator: str = "mean",
                        trim_fraction: float = 0.1, server=None,
                        server_lr: float = 1.0, transport=None,
                        downlink=None):
        if self.strategy == "sequential":
            return self._make_sequential_core(
                loss_fn, aggregator, trim_fraction, server, server_lr,
                transport, downlink)
        if self.mesh is None:
            return make_parallel_round_core(
                loss_fn, get_aggregator(aggregator,
                                        trim_fraction=trim_fraction),
                server, server_lr, transport=transport, downlink=downlink)
        if transport is not None:
            # a bound copy: reduce() runs the client-sharded kernels
            transport = transport.with_mesh(self.mesh, self.client_axes,
                                            self.reduce_tiers)
        core = make_parallel_round_core(
            loss_fn, self._resolve_aggregator(aggregator, trim_fraction),
            server, server_lr, transport=transport, downlink=downlink)
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
                              server, server_lr, transport, downlink):
        """round_core with ``make_parallel_round_core``'s contract, the
        clients one at a time (``mesh.py:115-153, 188-401``)."""
        if transport is not None and transport.name == "none":
            transport = None          # the identity codec: the plain core
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
            firsts, lasts = [], []

            def client(i):
                res = client_update(loss_fn, params, {
                    k: v[i] for k, v in batches.items()}, eta, hook)
                firsts.append(res.first_loss)
                lasts.append(res.last_loss)
                return res.params

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

    def make_slab_cores(self, *a, **kw):
        if self.strategy == "sequential":
            raise ValueError(
                "cohort_chunk requires the parallel strategy: the grouped "
                "sequential scan already streams clients without a slab "
                "decomposition")
        raise NotImplementedError(
            "cohort_chunk (streaming cohorts, make_slab_cores) is not ported "
            "to the MeshBackend yet: it comes with ROADMAP A13 (c)")

    def fleet_slices(self, n: int):
        raise NotImplementedError(
            "fleet_slices (carve_submeshes: fleet packing on sub-meshes) is "
            "not ported to the MeshBackend yet: it comes with ROADMAP A13 "
            "(c)")

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

    def place_transport_state(self, state, per_client: bool = False):
        """The codec's state on the device; per-client slots (leading
        cohort axis) cut to this rank's clients, whose batches it holds
        (the reference's ``_cohort_spec``)."""
        if not tree_leaves(state):
            return state
        if per_client:
            n = int(tree_leaves(state)[0].shape[0])
            lo, hi = self.rows(n)
            if (lo, hi) != (0, n):
                state = tree_map(lambda s: s[lo:hi], state)
        return self.place_params(state)

    def collect_transport_state(self, state, per_client: bool = False):
        """A bucket's per-client slots, this rank's clients, gathered back
        to the whole cohort's on every rank (other state passes)."""
        if not per_client or not tree_leaves(state):
            return state
        if self.strategy == "sequential":
            return tree_map(lambda s: all_gather_axis(s, self.mesh, "pod"),
                            state)
        if axes_size(self.mesh, self.client_axes) == 1:
            return state
        return tree_map(lambda s: all_gather_rows(s, self.mesh,
                                                  self.client_axes), state)

    def bind_downlink(self, codec):
        """Parallel: a bound copy, the int8 decode-apply runs the sharded
        kernel, one slice of the vector a rank. Sequential: the codec
        itself (each rank reconstructs the whole broadcast once a
        round)."""
        if codec is None or self.strategy == "sequential" or \
                self.mesh is None:
            return codec
        return codec.with_mesh(self.mesh, self.client_axes,
                               self.reduce_tiers)
