"""ExecutionBackend — where a federated round's client fan-out runs.

The port of ``repro.core.engine.backends.base``. The round's semantics
(ClientUpdate -> Aggregator -> ServerOptimizer) do not depend on the
backend; a backend decides the execution geometry:

  * how the round's client axis runs (one device: the whole cohort
    vmapped; a mesh: each rank vmaps its own block of client rows, or
    runs its groups' clients one at a time);
  * which implementation of the aggregation runs (the plain contraction,
    the kernel, or the client-sharded kernel plus a collective);
  * how host arrays are placed on the device (a plain copy, or only this
    rank's client rows and batch rows).

``RoundEngine`` takes its round core and its placement from a backend.
Placement hooks are idempotent: a tensor already placed passes through, so
the engine may call them on every bucket. Host arrays (numpy) are the whole
cohort; tensors count as placed. A bucket's etas and active mask stay on
the host: the client step takes eta as a number, and the host decides
which rounds run.

A backend may own a CUDA stream (``stream``; a fleet slice,
``LocalBackend.fleet_slices``): its placement and every round it runs are
then issued on that stream (``stream_context``), so packed sweep points
overlap on one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.engine.aggregators import LINEAR_AGGREGATORS
from repro_torch.data.pipeline import BucketBatch, SlabBatch
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
    #: the CUDA stream this backend's work is issued on (None: the
    #: caller's current stream)
    stream: Optional["torch.cuda.Stream"] = None

    def make_round_core(self, loss_fn: LossFn, *, aggregator: str = "mean",
                        trim_fraction: float = 0.1, server=None,
                        server_lr: float = 1.0, transport=None,
                        downlink=None):
        """round_core(params, batches{(N,K,b,...)}, weights(N,), eta,
        server_state, t_state=(), d_state=()) -> (new_params, first_losses
        (N,), last_losses (N,), server_state, t_state, d_state, level), as
        ``backends.local.make_parallel_round_core``."""
        raise NotImplementedError

    def program_signature(self) -> tuple:
        """What of the backend shapes its bucket programs beyond their
        inputs (the mesh's strategy, groups, accumulator dtype and
        reduce); part of the registry key where not empty."""
        return ()

    def make_slab_cores(self, loss_fn: LossFn, *, aggregator: str = "mean",
                        server=None, server_lr: float = 1.0, transport=None):
        """``(slab_core, finalize_core)`` for streaming cohorts, as
        ``backends.local.make_parallel_slab_cores``. A backend whose
        geometry cannot stream slabs refuses."""
        raise NotImplementedError(
            f"backend {self.name!r} does not support streaming cohorts "
            f"(cohort_chunk)")

    # ------------------------------------------------------------------
    # streams
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def stream_context(self):
        """Issue the enclosed work on this backend's stream. Entered from
        another stream, the backend's stream first waits for the caller's
        work, and the caller's waits for the enclosed work on the way out;
        entered from its own stream (a fleet point's thread) it waits for
        nothing, so packed points overlap. No stream: the caller's."""
        s = self.stream
        if s is None:
            yield
            return
        outer = torch.cuda.current_stream(s.device)
        if outer == s:
            yield
            return
        s.wait_stream(outer)
        with torch.cuda.stream(s):
            yield
        outer.wait_stream(s)

    def _placing(self):
        """Host -> device copies go on the backend's stream, the one their
        consumer runs on (placement may run on a builder's thread)."""
        return (contextlib.nullcontext() if self.stream is None
                else torch.cuda.stream(self.stream))

    # ------------------------------------------------------------------
    # placement (host -> device)
    # ------------------------------------------------------------------
    def to_device(self, x) -> torch.Tensor:
        with self._placing():
            return torch.as_tensor(x, device=self.device)

    def place_params(self, params: PyTree) -> PyTree:
        return tree_map(self.to_device, params)

    def place_batches(self, batches: Dict[str, Any]) -> Dict[str, Any]:
        """A bucket's batch arrays, leaves (B, N, K, b, ...)."""
        return {k: self.to_device(v) for k, v in batches.items()}

    def place_weights(self, weights) -> torch.Tensor:
        """A bucket's client weights (B, N)."""
        return self.to_device(weights)

    def place_scalars(self, etas, active):
        """A bucket's etas (B,) f32 and active mask (B,) bool, as host
        arrays."""
        return np.asarray(etas, np.float32), np.asarray(active, bool)

    def place_bucket(self, bb: BucketBatch) -> BucketBatch:
        """A bucket (leaves (B, N, ...), weights (B, N)) in one call: the
        builders' ``place_fn``, so the copy starts on the build thread."""
        return BucketBatch(
            batches={k: self.to_device(v) for k, v in bb.batches.items()},
            weights=self.to_device(bb.weights), active=bb.active,
            n_rounds=bb.n_rounds)

    def place_slab(self, sb: SlabBatch) -> SlabBatch:
        """A streaming round's slab (leaves (C, K, b, ...), weights (C,)):
        the builders' ``place_slab_fn``, so the next slab's copy starts on
        the build thread. Idempotent."""
        return dataclasses.replace(
            sb, batches={k: self.to_device(v) for k, v in sb.batches.items()},
            weights=self.to_device(sb.weights))

    def place_transport_state(self, state, per_client: bool = False):
        """The codec's error-feedback state: params-shaped (``per_client``:
        with a leading cohort axis), placed like the params (``()`` passes
        through)."""
        if not tree_leaves(state):
            return state
        return self.place_params(state)

    def collect_transport_state(self, state, per_client: bool = False):
        """The inverse of ``place_transport_state`` for a bucket's output
        state: the whole cohort's slots on every rank (identity on one
        device)."""
        return state

    # ------------------------------------------------------------------
    # fleet packing
    # ------------------------------------------------------------------
    def fleet_slices(self, n: int):
        """``n`` backends for ``n`` concurrent sweep points. Default: this
        backend, shared (its placement is stateless); ``LocalBackend``
        gives fresh slices."""
        return [self] * n

    # ------------------------------------------------------------------
    # codec binding
    # ------------------------------------------------------------------
    def bind_downlink(self, codec):
        """Bind a ``DownlinkCodec`` to the execution geometry: identity on
        one device; accepts and returns None."""
        return codec
