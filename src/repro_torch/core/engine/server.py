"""ServerOptimizer — the server-side step applied to the aggregated model.

    init(params)                                  -> state
    step(params, aggregate, state, server_lr)     -> (new_params, state)

FedOpt-style servers treat the pseudo-gradient ``delta = params - aggregate``
as a gradient; plain FedAvg is ``params + server_lr * (aggregate - params)``
(server_lr=1 is Algorithm 1 line 11 exactly).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

from repro_torch import optim
from repro_torch.api.registries import (SERVER_OPTIMIZER_REGISTRY,
                                        register_server_optimizer)

PyTree = Any

SERVER_OPTIMIZERS = ("avg", "fedadam", "fedavgm", "fedyogi")   # builtins


class ServerOptimizer(NamedTuple):
    init: Callable[[PyTree], Any]
    step: Callable[[PyTree, PyTree, Any, float], Tuple[PyTree, Any]]


def _avg() -> ServerOptimizer:
    def init(params):
        return ()

    def step(params, aggregate, state, server_lr):
        new = optim.tree_map(
            lambda p, a: (p + server_lr * (a - p)).to(p.dtype),
            params, aggregate)
        return new, state

    return ServerOptimizer(init, step)


def _from_optim(pair) -> ServerOptimizer:
    opt_init, opt_update = pair

    def step(params, aggregate, state, server_lr):
        delta = optim.tree_sub(params, aggregate)   # pseudo-gradient
        updates, state = opt_update(delta, state, params, server_lr)
        return optim.apply_updates(params, updates), state

    return ServerOptimizer(opt_init, step)


def get_server_optimizer(name) -> ServerOptimizer:
    """Resolve through ``SERVER_OPTIMIZER_REGISTRY``; a
    ``ServerOptimizer`` instance passes through."""
    if isinstance(name, ServerOptimizer):
        return name
    return SERVER_OPTIMIZER_REGISTRY.get(name)()


# builtin registrations: factory(**kw)
register_server_optimizer("avg", lambda **kw: _avg())
register_server_optimizer("fedadam",
                          lambda **kw: _from_optim(optim.fedadam_server()))
register_server_optimizer("fedavgm",
                          lambda **kw: _from_optim(optim.fedavgm_server()))
register_server_optimizer("fedyogi",
                          lambda **kw: _from_optim(optim.fedyogi_server()))
