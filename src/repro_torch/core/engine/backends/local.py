"""Single-device round core: the round's N clients as one vmapped update.

The port of ``make_parallel_round_core`` without transport or downlink
codecs (those arrive with the wire-path slice).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.core.engine.aggregators import Aggregator
from repro_torch.core.engine.client import make_client_update

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]], Any]


def make_parallel_round_core(loss_fn: LossFn, aggregator: Aggregator,
                             server, server_lr: float):
    """round_core(params, batches{(N,K,b,...)}, weights(N,), eta, state)
    -> (new_params, first_losses (N,), last_losses (N,), server_state)."""
    client = torch.func.vmap(make_client_update(loss_fn),
                             in_dims=(None, 0, None))

    def round_core(params, batches, weights, eta, server_state):
        client_params, first_losses, last_losses = client(params, batches,
                                                          eta)
        aggregate = aggregator(client_params, weights)
        new_params, server_state = server.step(params, aggregate,
                                               server_state, server_lr)
        return new_params, first_losses, last_losses, server_state

    return round_core
