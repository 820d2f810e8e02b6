"""ExecutionBackend — where a federated round's client fan-out runs.

The port of ``repro.core.engine.backends.base``. The round's semantics
(ClientUpdate -> Aggregator -> ServerOptimizer) do not depend on the
backend; a backend decides the execution geometry:

  * how the round's client axis runs (one device: the whole cohort
    vmapped; a mesh: each rank vmaps its own block of client rows);
  * which implementation of the aggregation runs (the plain contraction,
    the kernel, or the client-sharded kernel plus a collective);
  * how host arrays are placed on the device (a plain copy, or only this
    rank's client rows).

``RoundEngine`` takes its round core and its placement from a backend.
Placement hooks are idempotent: a tensor already placed passes through, so
the engine may call them on every round. Host arrays (numpy) are the whole
cohort; tensors count as placed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.core.engine.aggregators import LINEAR_AGGREGATORS
from repro_torch.data.pipeline import BucketBatch
from repro_torch.kernels.collectives import axes_size
from repro_torch.optim import tree_leaves, tree_map

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]], Any]

__all__ = ["ExecutionBackend", "LINEAR_AGGREGATORS", "axes_size"]


class ExecutionBackend:
    """Protocol plus the single-device placement defaults. Subclasses
    implement ``make_round_core`` and set ``device``."""

    name: str = "base"
    device: torch.device

    def make_round_core(self, loss_fn: LossFn, *, aggregator: str = "mean",
                        trim_fraction: float = 0.1, server=None,
                        server_lr: float = 1.0, transport=None,
                        downlink=None):
        """round_core(params, batches{(N,K,b,...)}, weights(N,), eta,
        server_state, t_state=(), d_state=()) -> (new_params, first_losses
        (N,), last_losses (N,), server_state, t_state, d_state, level), as
        ``backends.local.make_parallel_round_core``."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # placement (host -> device)
    # ------------------------------------------------------------------
    def to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def place_params(self, params: PyTree) -> PyTree:
        return tree_map(self.to_device, params)

    def place_batches(self, batches: Dict[str, Any]) -> Dict[str, Any]:
        """One round's batch arrays, leaves (N, K, b, ...)."""
        return {k: self.to_device(v) for k, v in batches.items()}

    def place_weights(self, weights) -> torch.Tensor:
        """One round's client weights (N,)."""
        return self.to_device(weights)

    def place_bucket(self, bb: BucketBatch) -> BucketBatch:
        """A bucket (leaves (B, N, ...), weights (B, N)) in one call: the
        builders' ``place_fn``, so the copy starts on the build thread."""
        return BucketBatch(
            batches={k: self.to_device(v) for k, v in bb.batches.items()},
            weights=self.to_device(bb.weights), active=bb.active,
            n_rounds=bb.n_rounds)

    def place_transport_state(self, state):
        """The codec's error-feedback state: params-shaped, placed like the
        params (``()`` passes through)."""
        if not tree_leaves(state):
            return state
        return self.place_params(state)

    # ------------------------------------------------------------------
    # codec binding
    # ------------------------------------------------------------------
    def bind_downlink(self, codec):
        """Bind a ``DownlinkCodec`` to the execution geometry: identity on
        one device; accepts and returns None."""
        return codec
