"""Single-device round core: the round's N clients as one vmapped update.

The port of ``make_parallel_round_core`` with its transport (uplink codec)
and downlink branches. The reference decodes the broadcast lazily inside
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

from repro_torch.core.engine.aggregators import Aggregator
from repro_torch.core.engine.client import make_client_update
from repro_torch.optim import tree_leaves

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
