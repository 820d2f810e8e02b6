"""MeshBackend — the round's client axis spread over the ranks of a mesh.

The port of ``repro.core.engine.backends.mesh``, parallel strategy only
(cross-device FL simulation). One process a device (``torch.distributed``);
the mesh is a DeviceMesh (``launch.mesh.make_mesh``) whose client axes,
``("pod", "data")`` or ``("data",)``, hold every rank.

Every rank draws the same cohort from the same numpy seed, so sampling and
K_r agree on every rank. Placement keeps this rank's contiguous block of
the cohort's rows (``collectives.row_range``: a block may be one row longer
than another, so the cohort need not divide among the ranks). Each rank
runs the vmapped client update on its rows, and the client-axis reductions
are the per-rank kernel plus a collective:

  * ``kernel`` -> ``ops.fedavg_reduce_tree_sharded``;
  * ``mean`` -> the weighted sum of this rank's rows, all-reduced (the
    contraction GSPMD makes of the reference's mean);
  * ``median``, ``trimmed_mean`` (or any other aggregator) -> the client
    stack all-gathered, then the aggregator on every rank;
  * a compressed uplink is bound to the mesh (``Transport.with_mesh``): its
    reduce runs the sharded kernel, and its error-feedback sum is
    all-reduced; the int8 downlink's decode-apply runs the sharded
    decode-apply (``bind_downlink``).

The server step, the downlink encode and the codec state run replicated on
every rank: the all-reduce hands every rank the same sum, so their inputs
agree. First and last losses are gathered to every rank.

``reduce="grouped"`` turns each all-reduce into one per client axis,
innermost first (within each pod, then across pods). On a mesh of one rank
every path gives ``LocalBackend``'s result bit for bit.

Differences from the reference: where it sends a cohort that does not
divide among the shards through the unsharded kernel (``mesh.py:227-229``,
``transport.py:334-335``), the port splits the cohort unevenly; the sums
agree within the 1e-6 the reference allows between groupings. Not ported,
and refused by name: ``strategy="sequential"``, streaming cohorts
(``make_slab_cores``), fleet sub-meshes (``fleet_slices``,
``carve_submeshes``), ``param_specs``, a ``"model"`` axis above 1 and
per-client error feedback (``Transport.ef_slots``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.engine.aggregators import get_aggregator
from repro_torch.core.engine.backends.base import ExecutionBackend, LossFn
from repro_torch.core.engine.backends.local import make_parallel_round_core
from repro_torch.data.pipeline import BucketBatch, slice_clients
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.collectives import (all_gather_rows,
                                             all_reduce_tiers, axes_size,
                                             rows_of)
from repro_torch.optim import tree_map

STRATEGIES = ("parallel",)
REDUCES = ("flat", "grouped")


class MeshBackend(ExecutionBackend):
    name = "mesh"

    def __init__(self, mesh, *, strategy: str = "parallel",
                 reduce: str = "flat"):
        """``mesh``: a DeviceMesh over every rank; the client rows spread
        over its ``("pod", "data")`` or ``("data",)`` axes, and any other
        axis must be of size 1. ``reduce``: ``"flat"`` for one all-reduce
        over all client axes, ``"grouped"`` for one per axis, innermost
        first."""
        if strategy not in STRATEGIES:
            raise ValueError(
                f"strategy={strategy!r} is not ported yet: the port's "
                f"MeshBackend runs {STRATEGIES}")
        if reduce not in REDUCES:
            raise ValueError(f"unknown reduce {reduce!r}; known: {REDUCES}")
        names = tuple(mesh.mesh_dim_names)
        if "model" in names and axes_size(mesh, ("model",)) > 1:
            raise ValueError(
                f"mesh axis 'model' of size {axes_size(mesh, ('model',))}: "
                f"tensor-parallel parameters come with the sequential "
                f"strategy, which is not ported")
        client_axes = ("pod", "data") if "pod" in names else ("data",)
        extra = [a for a in names
                 if a not in client_axes and axes_size(mesh, (a,)) > 1]
        if "data" not in names or extra:
            raise ValueError(f"the mesh {names} needs a 'data' axis, and "
                             f"every axis but 'pod' and 'data' of size 1")
        self.mesh = mesh
        self.strategy = strategy
        self.client_axes = client_axes
        self.reduce = reduce
        # innermost axis first: ("pod", "data") -> (("data",), ("pod",))
        self.reduce_tiers = (tuple((a,) for a in reversed(client_axes))
                             if reduce == "grouped" else None)
        self.device = resolve_device(mesh.device_type)
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())

    # ------------------------------------------------------------------
    # round core
    # ------------------------------------------------------------------
    def make_round_core(self, loss_fn: LossFn, *, aggregator: str = "mean",
                        trim_fraction: float = 0.1, server=None,
                        server_lr: float = 1.0, transport=None,
                        downlink=None):
        if transport is not None and transport.ef_slots:
            raise ValueError(
                f"transport.ef_slots={transport.ef_slots} (per-client error "
                f"feedback of a fixed cohort) is not ported to the "
                f"MeshBackend yet: each rank would hold its rows' slots")
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

    def make_slab_cores(self, *a, **kw):
        raise NotImplementedError(
            "cohort_chunk (streaming cohorts, make_slab_cores) is not ported "
            "to the MeshBackend yet")

    def fleet_slices(self, n: int):
        raise NotImplementedError(
            "fleet_slices (carve_submeshes: fleet packing on sub-meshes) is "
            "not ported to the MeshBackend yet")

    # ------------------------------------------------------------------
    # placement: this rank's client rows
    # ------------------------------------------------------------------
    def rows(self, n: int):
        """This rank's rows [lo, hi) of an ``n``-client cohort."""
        lo, hi = rows_of(self.mesh, self.client_axes, n)
        if hi == lo:
            raise ValueError(
                f"a cohort of {n} clients over "
                f"{axes_size(self.mesh, self.client_axes)} ranks leaves a "
                f"rank without a client row")
        return lo, hi

    def place_batches(self, batches: Dict[str, object]) -> Dict[str, object]:
        """Host leaves (N, K, b, ...) -> this rank's rows on the device;
        tensors are placed already and pass through."""
        out = {}
        for k, v in batches.items():
            if isinstance(v, np.ndarray):
                lo, hi = self.rows(v.shape[0])
                v = v[lo:hi]
            out[k] = self.to_device(v)
        return out

    def place_weights(self, weights) -> torch.Tensor:
        """Host weights (N,) -> this rank's rows; a tensor passes
        through."""
        if isinstance(weights, np.ndarray):
            lo, hi = self.rows(weights.shape[-1])
            weights = weights[..., lo:hi]
        return self.to_device(weights)

    def place_bucket(self, bb: BucketBatch) -> BucketBatch:
        """A host bucket (leaves (B, N, ...)) -> this rank's client rows on
        the device, sliced before the copy."""
        if isinstance(bb.weights, np.ndarray):
            bb = slice_clients(bb, *self.rows(bb.weights.shape[-1]))
        return super().place_bucket(bb)

    def bind_downlink(self, codec):
        """A bound copy: the int8 decode-apply runs the sharded kernel, one
        slice of the vector a rank."""
        if codec is None:
            return codec
        return codec.with_mesh(self.mesh, self.client_axes,
                               self.reduce_tiers)
