"""Single-device round core: the round's N clients as one vmapped update.

The port of ``make_parallel_round_core`` with its transport (uplink codec)
and downlink branches, and of ``LocalBackend``, the backend that runs it
on one device. The reference decodes the broadcast lazily inside
each vmapped client and relies on XLA to merge that decode with the
server's. A ctypes kernel cannot run under ``torch.func.vmap``, so here
the server reconstructs the broadcast once (``encode_broadcast``, through
the decode-apply kernel) and the clients start from that one tree: the
same arithmetic. Encoding and the fused reduce run outside the vmap, on
the stacked (N, M) deltas.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.core.engine.aggregators import Aggregator, get_aggregator
from repro_torch.core.engine.backends.base import ExecutionBackend
from repro_torch.core.engine.client import make_client_update
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import tree_leaves, tree_map

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]], Any]


def encode_broadcast(downlink, params, d_state):
    """Every downlink codec as ``(ref, payload, recon, new_state, level)``:
    codecs without a per-round level (all but ``adaptive``) give -1, which
    the trainer reads as "charge the configured ratio"."""
    out = downlink.encode_broadcast(params, d_state)
    if len(out) == 5:
        return out
    device = tree_leaves(params)[0].device
    return (*out, torch.tensor(-1, dtype=torch.int32, device=device))


def make_parallel_round_core(loss_fn: LossFn, aggregator: Aggregator,
                             server, server_lr: float, *, transport=None,
                             downlink=None):
    """round_core(params, batches{(N,K,b,...)}, weights(N,), eta,
    server_state, t_state=(), d_state=())
    -> (new_params, first_losses (N,), last_losses (N,), server_state,
        t_state, d_state, level).

    ``transport``: the clients' params go through the codec's delta
    pipeline (encode -> fused reduce) in place of the aggregator, threading
    the codec state ``t_state``. ``downlink``: the clients start from the
    reconstruction of the compressed broadcast, threading ``d_state``;
    ``level`` is the round's adaptive level (-1 for fixed-rate codecs),
    None without a downlink."""
    client = torch.func.vmap(make_client_update(loss_fn),
                             in_dims=(None, 0, None))

    def round_core(params, batches, weights, eta, server_state, t_state=(),
                   d_state=()):
        level = None
        if downlink is not None:
            _, _, params, d_state, level = encode_broadcast(
                downlink, params, d_state)
        client_params, first_losses, last_losses = client(params, batches,
                                                          eta)
        if transport is None:
            aggregate = aggregator(client_params, weights)
        else:
            aggregate, t_state = transport.aggregate(
                aggregator, params, client_params, weights, t_state)
        new_params, server_state = server.step(params, aggregate,
                                               server_state, server_lr)
        return (new_params, first_losses, last_losses, server_state, t_state,
                d_state, level)

    return round_core


def make_parallel_slab_cores(loss_fn: LossFn, aggregator: Aggregator,
                             server, server_lr: float, *, transport=None):
    """The streaming round: its U clients arrive as ceil(U/C) slabs of C,
    each slab folds into params-shaped f32 running sums, and only the
    finalize touches the server optimizer.

    slab_core(params, batches{(C,K,b,...)}, weights (C,), eta, acc, ef)
        -> (acc, first_losses (C,), last_losses (C,), ef_out)
    finalize_core(params, acc, server_state)
        -> (new_params, server_state, new_residual)

    ``acc = (hat_acc, true_acc)``: the sums of ``aggregator(...)`` (or of
    the codec's ``hat``) and, for a codec with aggregate error feedback,
    of its ``true``; ``(None, None)`` before the first slab, whose partials
    become the sums, so C == U is the dense round bit for bit. ``weights``
    are the slab's slice of the round's global weights (sum 1 over U, not
    over C), so partials add. ``ef``: the slab's slice of the per-client
    residual slots, the round's aggregate residual (read only), or ``()``.
    The sums are added in place: they are the slab cores' own tensors."""
    if transport is not None and transport.name == "none":
        transport = None            # the identity codec is the plain path
    agg_ef = (transport is not None and transport.error_feedback
              and not transport.ef_slots)
    client = torch.func.vmap(make_client_update(loss_fn),
                             in_dims=(None, 0, None))

    def fold(acc, part):
        part = tree_map(lambda x: x.to(torch.float32), part)
        if acc is None:
            return part
        return tree_map(lambda a, x: a.add_(x), acc, part)

    def slab_core(params, batches, weights, eta, acc, ef):
        client_params, first_losses, last_losses = client(params, batches,
                                                          eta)
        hat_acc, true_acc = acc
        if transport is None:
            hat_acc = fold(hat_acc, aggregator(client_params, weights))
        else:
            hat, true, ef = transport.aggregate_slab(params, client_params,
                                                     weights, ef)
            hat_acc = fold(hat_acc, hat)
            if agg_ef:
                true_acc = fold(true_acc, true)
        return (hat_acc, true_acc), first_losses, last_losses, ef

    def finalize_core(params, acc, server_state):
        hat_acc, true_acc = acc
        if transport is None:
            # the dense path's cast of the weighted sum to the params'
            # dtype, deferred to the round's end
            aggregate = tree_map(lambda a, p: a.to(p.dtype), hat_acc, params)
            new_res = ()
        else:
            aggregate = tree_map(lambda p, h: (p.to(torch.float32) + h)
                                 .to(p.dtype), params, hat_acc)
            new_res = (tree_map(torch.sub, true_acc, hat_acc) if agg_ef
                       else ())
        new_params, server_state = server.step(params, aggregate,
                                               server_state, server_lr)
        return new_params, server_state, new_res

    return slab_core, finalize_core


class LocalBackend(ExecutionBackend):
    """The whole cohort on one device (``device=None`` means the card).
    ``stream``: a CUDA stream its work is issued on (a fleet slice)."""

    name = "local"

    def __init__(self, device: DeviceLike = None, *, stream=None):
        self.device = resolve_device(device)
        self.stream = stream

    def make_round_core(self, loss_fn: LossFn, *, aggregator: str = "mean",
                        trim_fraction: float = 0.1, server=None,
                        server_lr: float = 1.0, transport=None,
                        downlink=None):
        agg = get_aggregator(aggregator, trim_fraction=trim_fraction)
        return make_parallel_round_core(loss_fn, agg, server, server_lr,
                                        transport=transport,
                                        downlink=downlink)

    def make_slab_cores(self, loss_fn: LossFn, *, aggregator: str = "mean",
                        server=None, server_lr: float = 1.0, transport=None):
        return make_parallel_slab_cores(loss_fn, get_aggregator(aggregator),
                                        server, server_lr,
                                        transport=transport)

    def fleet_slices(self, n: int):
        """``n`` fresh backends on this device, one for each packed sweep
        point; on the card each owns a new stream, so the points' rounds
        overlap on the card while each keeps its own prefetch thread."""
        make = ((lambda: torch.cuda.Stream(self.device))
                if self.device.type == "cuda" else (lambda: None))
        return [LocalBackend(self.device, stream=make()) for _ in range(n)]
