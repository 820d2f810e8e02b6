"""Optimizers on param dicts (the ``repro.optim`` pairs).

Each optimizer is an ``(init_fn, update_fn)`` pair on nested dicts of
tensors: ``state = init(params)``; ``updates, state = update(grads, state,
params, lr)``. Updates are added to params (optax convention). Clients use
plain SGD per the paper; the server averages (FedAvg) or runs one of these
on the averaged client delta.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

PyTree = Any


# ---------------------------------------------------------------------------
# param-dict arithmetic
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Map ``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, a)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def sgd():
    """Stateless SGD, the client optimizer of FedAvg."""
    def init(params):
        return ()

    def update(grads, state, params, lr):
        return tree_scale(grads, -lr), state

    return init, update


def momentum(beta: float = 0.9):
    def init(params):
        return tree_zeros_like(params)

    def update(grads, m, params, lr):
        m = tree_map(lambda mi, g: beta * mi + g, m, grads)
        return tree_map(lambda mi: mi * -lr, m), m

    return init, update


def _step_count(params) -> torch.Tensor:
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params) -> Dict[str, Any]:
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params),
                "t": _step_count(params)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vi, g: b2 * vi + (1 - b2) * torch.square(g),
                     state["v"], grads)
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)
        upd = tree_map(
            lambda mi, vi: -lr * (mi / bc1) / (torch.sqrt(vi / bc2) + eps),
            m, v)
        return upd, {"m": m, "v": v, "t": t}

    return init, update


def yogi(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3):
    """Yogi (Zaheer et al., 2018): Adam with the additive, sign-controlled
    second-moment update v += -(1-b2) * sign(v - g^2) * g^2."""
    def init(params) -> Dict[str, Any]:
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params),
                "t": _step_count(params)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
        v = tree_map(
            lambda vi, g: vi - (1 - b2) * torch.sign(vi - torch.square(g))
            * torch.square(g),
            state["v"], grads)
        bc1 = 1 - b1 ** t.to(torch.float32)
        upd = tree_map(
            lambda mi, vi: -lr * (mi / bc1)
            / (torch.sqrt(torch.clamp(vi, min=0.0)) + eps), m, v)
        return upd, {"m": m, "v": v, "t": t}

    return init, update


def fedadam_server(b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3):
    """Server-side Adam on the averaged client delta."""
    return adam(b1=b1, b2=b2, eps=eps)


def fedavgm_server(beta: float = 0.9):
    """Server momentum on the averaged client delta (Hsu et al., 2019)."""
    return momentum(beta=beta)


def fedyogi_server(b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3):
    """Server-side Yogi on the averaged client delta (Reddi et al., 2021)."""
    return yogi(b1=b1, b2=b2, eps=eps)
