"""GlobalModelStore: the one owner of the server-side model state
(``repro.core.engine.model_store``).

It holds ``params``, the server-optimizer state, the uplink codec's
error-feedback state (``transport_state``), the broadcast reference and
downlink residual (``downlink_state``), a monotone ``version`` that
advances once per committed round, and the cumulative cost counters. The
trainer's and the round engine's attributes of the same names read and
write it.

``snapshot`` returns ``(version, tree clients hold)``: the reference loaded
through the codec's ``load_tree`` when a downlink is set, else ``params``.
Where the rounds hold sharded params (a mesh's blocks), ``gather`` (set by
the engine) gives the snapshot and the checkpoint whole leaves, so neither
depends on the layout.
Checkpoint payloads keep the reference's key layout (``params``/``server``/
``transport``/``downlink`` plus flat counter meta), so a checkpoint of
either package restores into the other.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import TensorSpec, load_checkpoint
from repro_torch.optim import tree_map

PyTree = Any


def as_spec_tree(tree: PyTree, device=None) -> PyTree:
    """Shape, dtype and device template of ``tree`` (the ``like`` of
    ``load_checkpoint``) without copying any data; ``()`` and ``None``
    stay as they are. ``device`` overrides the leaves' own (so a ``meta``
    tree templates a load onto the card)."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype,
                          tree.device if device is None else device)
    if isinstance(tree, dict):
        return {k: as_spec_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(as_spec_tree(v, device) for v in tree)
    return tree


class GlobalModelStore:
    """Versioned owner of the server-side model state."""

    def __init__(self, params: PyTree = None, downlink=None):
        self.params: PyTree = params
        self.server_state: Any = None
        self.transport_state: Any = None
        self.downlink_state: Any = None
        self.downlink = downlink          # DownlinkCodec | None
        # blocks -> whole leaves (identity unless the params are sharded)
        self.gather: Callable[[PyTree], PyTree] = lambda tree: tree
        self.version: int = 0
        # cumulative simulated-cost counters (the reference's meta keys)
        self.wall: float = 0.0
        self.steps: int = 0
        self.up_mbit: float = 0.0
        self.down_mbit: float = 0.0
        self.min_loss: float = float("inf")
        self.max_acc: float = 0.0
        self.serve_queries: float = 0.0

    def advance(self, n: int = 1) -> int:
        """Bump the version by ``n`` committed rounds; returns it."""
        self.version += int(n)
        return self.version

    def snapshot(self) -> Tuple[int, PyTree]:
        """``(version, params_ref)``: the exact tree clients hold."""
        version = self.version
        dl, state = self.downlink, self.downlink_state
        params = self.gather(self.params)
        if dl is not None and state is not None:
            return version, dl.load_tree(self.gather(state["ref"]),
                                         like=params)
        return version, params

    # -- checkpoint payloads (the reference's key layout) -----------------
    def checkpoint_tree(self) -> Dict[str, PyTree]:
        """The store-owned tree; ``None`` and ``()`` entries hold no
        leaves."""
        g = self.gather
        return {"params": g(self.params), "server": g(self.server_state),
                "transport": g(self.transport_state),
                "downlink": g(self.downlink_state)}

    def counters_meta(self) -> Dict[str, Any]:
        """Flat counter meta, the reference's keys."""
        return {"steps": self.steps, "up_mbit": self.up_mbit,
                "down_mbit": self.down_mbit, "min_loss": self.min_loss,
                "max_acc": self.max_acc, "serve_queries": self.serve_queries,
                "store_version": self.version}

    def state_dict(self) -> Dict[str, Any]:
        return {"tree": self.checkpoint_tree(), "meta": self.counters_meta()}

    def load_counters_meta(self, meta: Dict[str, Any],
                           default_version: int) -> None:
        """Restore the counters from checkpoint meta. Meta without
        ``store_version`` (or ``down_mbit``, ``serve_queries``) takes
        ``default_version`` (the round count) and zeros, as the
        reference's."""
        self.steps = int(meta["steps"])
        self.up_mbit = float(meta["up_mbit"])
        self.down_mbit = float(meta.get("down_mbit", 0.0))
        self.min_loss = float(meta["min_loss"])
        self.max_acc = float(meta["max_acc"])
        self.serve_queries = float(meta.get("serve_queries", 0.0))
        self.version = int(meta.get("store_version", default_version))

    # -- checkpoint IO ----------------------------------------------------
    def load_checkpoint_tree(self, path: str,
                             extra_like: Optional[Dict[str, PyTree]] = None,
                             ) -> Tuple[Dict[str, PyTree], Dict[str, Any]]:
        """Load the store-owned tree (plus ``extra_like`` entries) from
        ``path``, templated on the current store.

        Legacy keys: a checkpoint of an f32-ref run (or one written before
        the q8 store) holds the downlink reference and residual as f32
        trees under the same keys. When this store wants q8 the load
        raises ``KeyError`` on the missing q8 sub-keys; reload against f32
        templates and re-bracket through ``store_tree``, so the run still
        holds one quantised copy."""
        like = as_spec_tree({**self.checkpoint_tree(), **(extra_like or {})})
        try:
            return load_checkpoint(path, like)
        except KeyError:
            dl = self.downlink
            if dl is None or dl.ref_store == "f32":
                raise
            f32 = tree_map(lambda p: TensorSpec(tuple(p.shape),
                                                torch.float32, p.device),
                           self.params)
            like["downlink"] = {"ref": as_spec_tree(self.params),
                                "res": f32 if dl.error_feedback else ()}
            tree, meta = load_checkpoint(path, like)
            d = tree["downlink"]
            tree["downlink"] = {
                "ref": dl.store_tree(d["ref"]),
                "res": (dl.store_tree(d["res"]) if dl.error_feedback
                        else ())}
            return tree, meta

    def restore_tree(self, tree: Dict[str, PyTree], *,
                     place_params: Optional[Callable[[PyTree], PyTree]] = None,
                     place: Optional[Callable[[PyTree], PyTree]] = None,
                     ) -> None:
        """Adopt a loaded checkpoint tree; ``place_params``/``place`` let an
        engine re-place the tensors."""
        pp = place_params if place_params is not None else (lambda t: t)
        pl = place if place is not None else (lambda t: t)
        self.params = pp(tree["params"])
        self.server_state = pl(tree["server"])
        self.transport_state = pl(tree["transport"])
        self.downlink_state = pl(tree["downlink"])
