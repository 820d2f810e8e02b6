"""ClientUpdate — K steps of local SGD (Algorithm 1, lines 5-9).

The update is stateless plain SGD per the paper. It is written for one
client; ``backends.local`` vmaps it over the round's clients with
``torch.func.vmap``, so every op below runs once for the whole cohort, and
the mesh's sequential strategy calls it once a client.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad_and_value

from repro_torch.optim import tree_map

PyTree = Any
LossFn = Callable[[PyTree, Dict[str, torch.Tensor]], Any]
GradHook = Callable[[PyTree, torch.Tensor, Dict[str, torch.Tensor]],
                    Tuple[PyTree, torch.Tensor]]


class ClientResult(NamedTuple):
    """One client's round output."""
    params: PyTree               # x_{r,K}^c — params after K local steps
    first_loss: torch.Tensor     # f_c(x_r, xi_{c,0}) — Eq. 15 feedback signal
    last_loss: torch.Tensor      # f_c(x_{r,K-1}, xi_{c,K-1})


def client_update(loss_fn: LossFn, params: PyTree,
                  client_batches: Dict[str, torch.Tensor],
                  eta: float, grad_hook: Optional[GradHook] = None
                  ) -> ClientResult:
    """K steps of SGD from the round-start params. Leaves of
    ``client_batches`` have a leading K axis; each update is cast back to
    its weight's dtype. ``grad_hook(grads, loss, batch) -> (grads,
    loss)``, where given, sees each step's gradients and loss before the
    update (the sequential mesh strategy all-reduces them over the ranks
    that split the client's batch)."""
    step_grad = grad_and_value(loss_fn, has_aux=True)
    k = next(iter(client_batches.values())).shape[0]
    p, first = params, None
    for t in range(k):
        batch = {key: v[t] for key, v in client_batches.items()}
        grads, (loss, _) = step_grad(p, batch)
        if grad_hook is not None:
            grads, loss = grad_hook(grads, loss, batch)
        p = tree_map(lambda w, g: (w - eta * g).to(w.dtype), p, grads)
        if t == 0:
            first = loss
    return ClientResult(p, first, loss)


def make_client_update(loss_fn: LossFn):
    """Bind ``loss_fn``: returns update(params, batches, eta) ->
    ClientResult."""
    def update(params, client_batches, eta):
        return client_update(loss_fn, params, client_batches, eta)

    return update
