"""FedAvg with decaying local steps: public names + the per-round oracle.

``run_reference_rounds`` is the seed trainer's inner loop: one round per
call, one blocking loss read per round. The port's ``FedAvgTrainer`` must
equal it bitwise (tests/test_torch_engine.py), as the reference's trainer
equals its own copy of this loop.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.engine.round import make_round_fn
from repro_torch.core.engine.server import get_server_optimizer
from repro_torch.core.engine.trainer import FedAvgTrainer, History, make_eval_fn
from repro_torch.core.schedules import DecayController
from repro_torch.data import pipeline
from repro_torch.data.synthetic import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import tree_map

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]], Any]

__all__ = ["FedAvgTrainer", "History", "make_eval_fn", "make_round_fn",
           "ReferenceRun", "run_reference_rounds"]


class ReferenceRun(NamedTuple):
    params: PyTree
    losses: np.ndarray       # per-round mean first-step losses
    ks: List[int]            # per-round K_r actually executed
    round_fn: Any            # pass back in to reuse


def run_reference_rounds(loss_fn: LossFn, params: PyTree,
                         data: FederatedData, fed: FedConfig,
                         rounds: int, *, round_fn=None,
                         device: DeviceLike = None) -> ReferenceRun:
    """Per-round loop following the configured K/eta schedules through a
    fresh ``DecayController``, with the loss fed back every round. Runs on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    ctrl = DecayController(fed)
    if round_fn is None:
        round_fn, _ = make_round_fn(loss_fn, server=fed.server_optimizer,
                                    server_lr=fed.server_lr,
                                    aggregator=fed.aggregator,
                                    device=device)
    params = tree_map(lambda p: torch.as_tensor(p, device=device), params)
    server_state = get_server_optimizer(fed.server_optimizer).init(params)
    rng = np.random.default_rng(fed.seed)
    losses, ks = [], []
    for r in range(1, rounds + 1):
        k_r = ctrl.k_for_round(r)
        eta_r = ctrl.eta_for_round(r)
        ids = pipeline.sample_clients(rng, data, fed.clients_per_round)
        batches = pipeline.round_batches(rng, data, ids, k_r, fed.batch_size)
        weights = pipeline.client_weights(data, ids)
        params, first_losses, _, server_state = round_fn(
            params, batches, weights, eta_r, server_state)
        loss = float(np.mean(first_losses.cpu().numpy()))  # per-round sync
        ctrl.observe_round_losses(loss)
        losses.append(loss)
        ks.append(k_r)
    return ReferenceRun(params, np.asarray(losses), ks, round_fn)
