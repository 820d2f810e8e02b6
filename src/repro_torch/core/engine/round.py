"""Round execution: the single-round core and the bucket executor.

Layering, as in ``repro.core.engine.round``:

    ClientUpdate    (engine.client)      — K-step local SGD, vmapped over clients
    Aggregator      (engine.aggregators) — client stack -> aggregate
    ServerOptimizer (engine.server)      — aggregate -> next global params
    ExecutionBackend (engine.backends)   — where the fan-out runs: one device
                                           (LocalBackend) or the ranks of a
                                           mesh (MeshBackend)

PyTorch runs eagerly, so there is no executable registry: ``run_bucket``
executes one round, and the trainer calls it once per round of a bucket.
``dispatch_count`` counts ``run_bucket`` calls. The reference's
``compile_count`` has no counterpart yet.

With a transport or downlink codec (``engine.transport``) the engine threads
the codec state (``transport_state``, ``downlink_state``) through every
``run_bucket``; the state lives in a ``GlobalModelStore`` (the engine's own,
or the trainer's after ``bind_store``). A codec bound to a fixed cohort
(``Transport.with_ef_slots``) holds one residual a cohort slot, leaves
``(ef_slots, ...)``; the engine threads it the same way, and slot j meets
client cohort[j] in every round (reference ``round.py:313-364``, :503,
:553).

Streaming cohorts (``cohort_chunk=C``): ``run_round_chunked`` runs one
round as ceil(U/C) slabs of C clients through the backend's slab cores
(``make_slab_cores``), so the device holds C clients' state at a time
(reference ``round.py:531-590``). Per-client residual slices commit after
the round's finalize, never mid-round.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine.aggregators import (LINEAR_AGGREGATORS,
                                                 get_aggregator)
from repro_torch.core.engine.backends import (ExecutionBackend,
                                              LocalBackend,
                                              make_parallel_round_core)
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.engine.server import get_server_optimizer
from repro_torch.core.engine.transport import get_downlink, get_transport
from repro_torch.data.pipeline import BucketBatch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import tree_map

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]], Any]


def _eta(eta) -> float:
    """The client learning rate rounded to f32, as the reference feeds it."""
    return float(np.float32(eta))


class RoundEngine:
    """Runs buckets of rounds; its backend decides where."""

    def __init__(self, loss_fn: LossFn, *, aggregator: str = "mean",
                 trim_fraction: float = 0.1, server: str = "avg",
                 server_lr: float = 1.0,
                 backend: Optional[ExecutionBackend] = None, transport=None,
                 topk_frac: float = 0.1, downlink=None,
                 downlink_ref: str = "f32", cohort_chunk=None,
                 device: DeviceLike = None):
        """``transport``: None/"none" keeps the plain aggregator path;
        "int8"/"int8x2"/"topk" (or a ``Transport``) aggregates compressed
        deltas and needs a linear aggregator. ``downlink``: None/"none"
        keeps the uncompressed broadcast; a codec name makes every round
        start from ``params_ref + decode(payload)``. ``downlink_ref``: the
        store of the broadcast reference and residual, "f32" or "q8";
        anything but "f32" needs a downlink codec. ``backend``: the round
        core and the placement (None: ``LocalBackend(device)``); a given
        backend brings its device, which ``device`` may only repeat.
        ``cohort_chunk``: stream each round in slabs of this many clients
        (``run_round_chunked``); needs a linear aggregator and no downlink
        codec."""
        if backend is None:
            backend = LocalBackend(device)
        elif device is not None and \
                torch.device(device).type != backend.device.type:
            raise ValueError(f"device={str(device)!r} but the {backend.name} "
                             f"backend runs on {backend.device}")
        self.backend = backend
        self.device = backend.device
        self.transport = get_transport(transport, topk_frac=topk_frac)
        if self.transport is not None and \
                self.transport.name != "none" and \
                aggregator not in LINEAR_AGGREGATORS:
            raise ValueError(
                f"transport {self.transport.name!r} requires a linear "
                f"aggregator {LINEAR_AGGREGATORS}, got {aggregator!r}")
        self.downlink = backend.bind_downlink(
            get_downlink(downlink, topk_frac=topk_frac,
                         ref_store=downlink_ref))
        if self.downlink is None and downlink_ref != "f32":
            raise ValueError(
                f"downlink_ref={downlink_ref!r} requires a downlink codec")
        self.server = get_server_optimizer(server)
        self.round_core = backend.make_round_core(
            loss_fn, aggregator=aggregator, trim_fraction=trim_fraction,
            server=self.server, server_lr=server_lr,
            transport=self.transport, downlink=self.downlink)
        self.cohort_chunk = cohort_chunk
        if cohort_chunk:
            if self.downlink is not None:
                raise ValueError(
                    "cohort_chunk cannot combine with a downlink codec: the "
                    "broadcast reference advances round-atomically and "
                    "does not stream over slabs")
            if aggregator not in LINEAR_AGGREGATORS:
                raise ValueError(
                    f"cohort_chunk requires a linear aggregator "
                    f"{LINEAR_AGGREGATORS}: streaming slabs fold into a "
                    f"running weighted sum, got {aggregator!r}")
            self.slab_core, self.finalize_core = backend.make_slab_cores(
                loss_fn, aggregator=aggregator, server=self.server,
                server_lr=server_lr, transport=self.transport)
        self.dispatch_count = 0
        # the codec state lives in a store: this private one until a
        # trainer binds its own (``bind_store``)
        self._store = GlobalModelStore(downlink=self.downlink)
        #: the int32 adaptive downlink level of the most recent round, on
        #: the device (-1 for fixed-rate codecs); None without a downlink
        self.last_downlink_levels = None

    def bind_store(self, store: GlobalModelStore) -> GlobalModelStore:
        """Adopt a trainer-owned store as the owner of the codec state;
        state the private store holds moves over, and so does the codec
        binding, so ``store.snapshot()`` loads through this downlink."""
        store.downlink = self.downlink
        store.transport_state = self._store.transport_state
        store.downlink_state = self._store.downlink_state
        self._store = store
        return store

    transport_state = property(
        lambda self: self._store.transport_state,
        lambda self, v: setattr(self._store, "transport_state", v))
    downlink_state = property(
        lambda self: self._store.downlink_state,
        lambda self, v: setattr(self._store, "downlink_state", v))

    def to_device(self, x) -> torch.Tensor:
        return self.backend.to_device(x)

    def place_bucket(self, bb: BucketBatch) -> BucketBatch:
        """Host -> device copy of a bucket's batches and weights, this
        rank's client rows on a mesh (the builders' ``place_fn``)."""
        return self.backend.place_bucket(bb)

    def init_server_state(self, params: PyTree) -> Any:
        return self.server.init(params)

    def init_transport_state(self, params: PyTree) -> Any:
        """Create (and own) the uplink codec's error-feedback state."""
        self.transport_state = (() if self.transport is None
                                else self.transport.init_state(params))
        return self.transport_state

    def init_downlink_state(self, params: PyTree) -> Any:
        """Create (and own) the broadcast reference and downlink
        residual."""
        self.downlink_state = (() if self.downlink is None
                               else self.downlink.init_state(params))
        return self.downlink_state

    def run_bucket(self, params, batches, weights, eta, server_state
                   ) -> Tuple[PyTree, torch.Tensor, torch.Tensor, Any]:
        """One round: batches leaves (N, K, b, ...); weights (N,), host
        arrays of the whole cohort or tensors placed by ``place_bucket``.
        Returns (params, first_losses (N,), last_losses (N,), state)."""
        be = self.backend
        params = be.place_params(params)
        if self.transport_state is None:
            self.init_transport_state(params)
        if self.downlink_state is None:
            self.init_downlink_state(params)
        (params, firsts, lasts, server_state, self.transport_state,
         self.downlink_state, self.last_downlink_levels) = self.round_core(
            params, be.place_batches(batches), be.place_weights(weights),
            _eta(eta), server_state,
            be.place_transport_state(self.transport_state),
            self.downlink_state)
        self.dispatch_count += 1
        return params, firsts, lasts, server_state

    def run_round_chunked(self, params, slabs, eta, server_state
                          ) -> Tuple[PyTree, torch.Tensor, torch.Tensor, Any]:
        """One round as streamed C-client slabs.

        ``slabs``: ``pipeline.SlabBatch``es covering the round's cohort in
        order (host arrays or placed by ``place_slab``). The device holds
        the params-shaped f32 sums and the current slab's residual slice
        across slabs. Returns ``run_bucket``'s 4-tuple, the losses
        ``(1, U)``. Per-client residual slices are kept aside and replace
        ``transport_state`` only after the finalize, so a checkpoint
        between rounds never sees mid-round state; one dispatch a
        round."""
        if not self.cohort_chunk:
            raise ValueError("engine was built without cohort_chunk")
        be = self.backend
        params = be.place_params(params)
        t = self.transport
        if t is not None and self.transport_state is None:
            self.init_transport_state(params)
        per_client = t is not None and t.ef_slots is not None
        agg_ef = t is not None and t.error_feedback and not per_client
        eta = _eta(eta)
        acc = (None, None)
        firsts, lasts, ef_parts = [], [], []
        for sb in slabs:
            sb = be.place_slab(sb)
            ef = ()
            if per_client:
                ef = tree_map(lambda s: s[sb.start:sb.stop],
                              self.transport_state)
            elif agg_ef:
                ef = self.transport_state
            acc, f, l, ef = self.slab_core(params, sb.batches, sb.weights,
                                           eta, acc, ef)
            firsts.append(f)
            lasts.append(l)
            if per_client:
                ef_parts.append(ef)
        if not firsts:
            raise ValueError("run_round_chunked got an empty slab stream")
        new_params, server_state, new_res = self.finalize_core(
            params, acc, server_state)
        if per_client:
            self.transport_state = tree_map(
                lambda *xs: torch.cat(xs, dim=0), *ef_parts)
        elif agg_ef:
            self.transport_state = new_res
        self.dispatch_count += 1
        return (new_params, torch.cat(firsts)[None], torch.cat(lasts)[None],
                server_state)


def make_round_fn(loss_fn: LossFn, *, server: str = "avg",
                  server_lr: float = 1.0, aggregator: str = "mean",
                  device: DeviceLike = None):
    """Single-round builder.

    round_fn(params, batches{(N,K,b,...)}, weights (N,), eta, server_state)
        -> (new_params, first_losses (N,), mean_last_loss, server_state)

    Returns ``(round_fn, srv_init)``; ``srv_init`` is None for the stateless
    ``avg`` server (its state is ``()``). Inputs may be numpy arrays or
    tensors; they are placed on ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    srv = get_server_optimizer(server)
    core = make_parallel_round_core(loss_fn, get_aggregator(aggregator), srv,
                                    server_lr)

    def round_fn(params, batches, weights, eta, server_state):
        place = lambda x: torch.as_tensor(x, device=device)
        new_params, first_losses, last_losses, server_state = core(
            tree_map(place, params), {k: place(v) for k, v in
                                      batches.items()},
            place(weights), _eta(eta), server_state)[:4]
        return new_params, first_losses, torch.mean(last_losses), \
            server_state

    srv_init = None if server == "avg" else srv.init
    return round_fn, srv_init
