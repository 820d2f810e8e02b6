"""Public entry points of the port's kernels (the names of
``repro.kernels.ops``). Each dispatches by the tensor's device: the
hand-written kernel on CUDA, the plain version on the CPU."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import fedavg_reduce as _fr

PyTree = Any


def fedavg_reduce(client_stack: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """(N, M) x (N,) -> (M,)."""
    return _fr.fedavg_reduce(client_stack, weights)


def fedavg_reduce_tree(client_params: PyTree, weights: torch.Tensor) -> PyTree:
    """Weighted-average every leaf of a client-stacked param dict, one
    launch per leaf: (N, ...) -> (...)."""
    if isinstance(client_params, dict):
        return {k: fedavg_reduce_tree(v, weights)
                for k, v in client_params.items()}
    n = client_params.shape[0]
    flat = client_params.reshape(n, -1).contiguous()
    return fedavg_reduce(flat, weights).reshape(client_params.shape[1:])
