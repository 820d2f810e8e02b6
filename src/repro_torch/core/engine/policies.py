"""The aggregation-policy and staleness-weight builtins
(``repro.core.engine.async_buffer``, its registrations).

``AGGREGATION_REGISTRY``: ``sync`` builds ``FedAvgTrainer``; ``async`` (the
FedBuff-style buffered engine) is registered so specs validate as the
reference's do, and its factory refuses by name until ROADMAP A7 ports it.
``STALENESS_WEIGHT_REGISTRY``: the async buffer's per-arrival scale of a
staleness s, copied from the reference: ``constant`` 1, ``inv`` 1/(1+s),
``poly`` (1+s)^-0.5.
"""
from __future__ import annotations

from repro_torch.api.registries import (register_aggregation,
                                        register_staleness_weight)

#: exponent of the ``poly`` staleness weight
POLY_ALPHA = 0.5

register_staleness_weight("constant", lambda **kw: lambda s: 1.0)
register_staleness_weight("inv", lambda **kw: lambda s: 1.0 / (1.0 + s))
register_staleness_weight(
    "poly", lambda **kw: lambda s: (1.0 + s) ** (-POLY_ALPHA))


def _sync_policy(loss_fn, init_params, data, fed, runtime, *, eval_fn=None,
                 backend=None, device=None, **kw):
    from repro_torch.core.engine.trainer import FedAvgTrainer
    return FedAvgTrainer(loss_fn, init_params, data, fed, runtime,
                         eval_fn=eval_fn, backend=backend, device=device)


def _async_policy(*a, **kw):
    raise ValueError("fed.aggregation='async' is not ported yet: the "
                     "buffered async engine comes with ROADMAP A7")


register_aggregation("sync", lambda **kw: _sync_policy)
register_aggregation("async", lambda **kw: _async_policy)
