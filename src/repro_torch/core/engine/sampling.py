"""ClientSampler — who participates in each round, and with what weights.

The port has the ``uniform`` sampler only: a without-replacement draw that
consumes exactly the reference's rng stream. The other samplers of
``repro.core.engine.sampling`` wait for a later slice; asking for one
raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.data.pipeline import client_weights, sample_clients
from repro_torch.data.synthetic import FederatedData

SAMPLERS = ("uniform",)


class ClientSampler:
    """Protocol. ``round(rng, data, n, round_idx)`` -> (ids (n,), weights
    (n,) f32 summing to 1)."""

    name: str = "base"

    def sample(self, rng: np.random.Generator, data: FederatedData, n: int,
               round_idx: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def weights(self, data: FederatedData, ids: np.ndarray) -> np.ndarray:
        return client_weights(data, ids)

    def round(self, rng: np.random.Generator, data: FederatedData, n: int,
              round_idx: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        ids = self.sample(rng, data, n, round_idx)
        return ids, self.weights(data, ids)


class UniformSampler(ClientSampler):
    """Uniform without replacement — the historical draw, draw for draw."""

    name = "uniform"

    def sample(self, rng, data, n, round_idx=None):
        return sample_clients(rng, data, n)


def make_sampler(fed) -> ClientSampler:
    """The trainer's entry point: build the FedConfig's sampler."""
    name = getattr(fed, "sampler", "uniform") or "uniform"
    if name != "uniform":
        raise ValueError(f"fed.sampler={name!r} is not ported yet; the port "
                         f"has {SAMPLERS}")
    return UniformSampler()
