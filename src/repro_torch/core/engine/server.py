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

PyTree = Any

SERVER_OPTIMIZERS = ("avg", "fedadam", "fedavgm", "fedyogi")


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


_FACTORIES = {
    "avg": _avg,
    "fedadam": lambda: _from_optim(optim.fedadam_server()),
    "fedavgm": lambda: _from_optim(optim.fedavgm_server()),
    "fedyogi": lambda: _from_optim(optim.fedyogi_server()),
}


def get_server_optimizer(name) -> ServerOptimizer:
    """Resolve by name; a ``ServerOptimizer`` instance passes through."""
    if isinstance(name, ServerOptimizer):
        return name
    if name not in _FACTORIES:
        raise ValueError(f"unknown server optimizer {name!r}; known: "
                         f"{SERVER_OPTIMIZERS}")
    return _FACTORIES[name]()
