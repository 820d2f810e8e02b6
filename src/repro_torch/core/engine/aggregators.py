"""Cross-client aggregation (Algorithm 1, line 11 generalised).

An aggregator maps a client-stacked param dict (leaves ``(N, ...)``) and
per-client weights ``(N,)`` to the aggregated dict (leaves ``(...)``):

  * ``mean``         — weighted mean, f32 contraction over the client axis
  * ``kernel``       — the same through the CUDA ``fedavg_reduce`` kernel
  * ``median``       — coordinate-wise median (ignores weights)
  * ``trimmed_mean`` — coordinate-wise trimmed mean (ignores weights)
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.api.registries import (AGGREGATOR_REGISTRY,
                                        register_aggregator)
from repro_torch.kernels import ops as kops
from repro_torch.optim import tree_map

PyTree = Any
Aggregator = Callable[[PyTree, torch.Tensor], PyTree]


def weighted_mean(client_params: PyTree, weights: torch.Tensor) -> PyTree:
    """sum_c p_c * x_c, accumulated in f32, cast back to storage dtype."""
    w32 = weights.to(torch.float32)
    return tree_map(
        lambda cp: torch.tensordot(w32, cp.to(torch.float32), dims=1
                                   ).to(cp.dtype),
        client_params)


def kernel_mean(client_params: PyTree, weights: torch.Tensor) -> PyTree:
    """Weighted mean through the ``fedavg_reduce`` kernel, one launch per
    leaf."""
    return kops.fedavg_reduce_tree(client_params, weights)


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0 with the mean of the two middle values for even
    N, as ``jnp.median`` (``torch.median`` takes the lower one)."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def coordinate_median(client_params: PyTree, weights: torch.Tensor) -> PyTree:
    """Per-coordinate median over the client axis (weights unused)."""
    del weights
    return tree_map(lambda cp: _median(cp.to(torch.float32)).to(cp.dtype),
                    client_params)


def trimmed_mean(client_params: PyTree, weights: torch.Tensor,
                 trim_fraction: float = 0.1) -> PyTree:
    """Drop the ``floor(trim_fraction * N)`` (but, for any positive
    fraction, at least one) largest and smallest values per coordinate,
    then average the survivors uniformly (weights unused)."""
    del weights

    def one(cp):
        n = cp.shape[0]
        t = max(1, int(trim_fraction * n)) if trim_fraction > 0 else 0
        if 2 * t >= n:          # degenerate trim -> median
            return _median(cp.to(torch.float32)).to(cp.dtype)
        s = torch.sort(cp.to(torch.float32), dim=0).values
        kept = s[t:n - t] if t else s
        return torch.mean(kept, dim=0).to(cp.dtype)

    return tree_map(one, client_params)


AGGREGATORS = ("mean", "kernel", "median", "trimmed_mean")   # builtins
#: aggregators the weighted sum distributes over, so a compressed codec can
#: aggregate decoded payloads in their place
LINEAR_AGGREGATORS = ("mean", "kernel")


def get_aggregator(name, *, trim_fraction: float = 0.1) -> Aggregator:
    """Resolve an aggregator through ``AGGREGATOR_REGISTRY``; a callable
    passes through."""
    if callable(name):
        return name
    return AGGREGATOR_REGISTRY.get(name)(trim_fraction=trim_fraction)


# builtin registrations: factory(*, trim_fraction, **kw)
register_aggregator("mean", lambda **kw: weighted_mean)
register_aggregator("kernel", lambda **kw: kernel_mean)
register_aggregator("median", lambda **kw: coordinate_median)
register_aggregator(
    "trimmed_mean",
    lambda *, trim_fraction=0.1, **kw: (
        lambda cp, w: trimmed_mean(cp, w, trim_fraction)))
