"""The aggregation-policy and staleness-weight builtins
(``repro.core.engine.async_buffer``, its registrations).

``AGGREGATION_REGISTRY``: ``sync`` builds ``FedAvgTrainer``; ``async``
builds the FedBuff-style ``AsyncBufferedEngine``.
``STALENESS_WEIGHT_REGISTRY``: the async buffer's per-arrival scale of a
staleness s, copied from the reference: ``constant`` 1, ``inv`` 1/(1+s),
``poly`` (1+s)^-0.5.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.api.registries import (STALENESS_WEIGHT_REGISTRY,
                                        register_aggregation,
                                        register_staleness_weight)

STALENESS_WEIGHTS = ("constant", "inv", "poly")   # builtins
#: exponent of the ``poly`` staleness weight
POLY_ALPHA = 0.5

register_staleness_weight("constant", lambda **kw: lambda s: 1.0)
register_staleness_weight("inv", lambda **kw: lambda s: 1.0 / (1.0 + s))
register_staleness_weight(
    "poly", lambda **kw: lambda s: (1.0 + s) ** (-POLY_ALPHA))


def get_staleness_weight(name) -> Callable[[int], float]:
    """A staleness weight through ``STALENESS_WEIGHT_REGISTRY``; a callable
    passes through."""
    if callable(name):
        return name
    return STALENESS_WEIGHT_REGISTRY.get(name)()


def _sync_policy(loss_fn, init_params, data, fed, runtime, *, eval_fn=None,
                 backend=None, device=None, registry=None, program_key=None,
                 **kw):
    from repro_torch.core.engine.trainer import FedAvgTrainer
    return FedAvgTrainer(loss_fn, init_params, data, fed, runtime,
                         eval_fn=eval_fn, backend=backend, device=device,
                         registry=registry, program_key=program_key)


def _async_policy(loss_fn, init_params, data, fed, runtime, *, eval_fn=None,
                  backend=None, device=None, registry=None,
                  program_key=None, **kw):
    from repro_torch.core.engine.async_buffer import AsyncBufferedEngine
    return AsyncBufferedEngine(loss_fn, init_params, data, fed, runtime,
                               eval_fn=eval_fn, backend=backend,
                               device=device, registry=registry,
                               program_key=program_key)


register_aggregation("sync", lambda **kw: _sync_policy)
register_aggregation("async", lambda **kw: _async_policy)
