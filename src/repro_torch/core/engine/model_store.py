"""GlobalModelStore: the server-side model state that serving reads
(``repro.core.engine.model_store``, the serving part).

It holds ``params``, a monotone ``version`` that advances once per
committed round, and, with a downlink codec, the broadcast reference that
clients hold. ``snapshot`` returns ``(version, tree clients hold)``: the
reference loaded through the codec's ``load_tree`` when a downlink is set,
else ``params``. Checkpoint payloads (``state_dict``) wait for the
checkpoint port.
"""
from __future__ import annotations

from typing import Any, Tuple

PyTree = Any


class GlobalModelStore:
    """Versioned owner of the server-side model state."""

    def __init__(self, params: PyTree = None, downlink=None):
        self.params: PyTree = params
        self.downlink = downlink          # DownlinkCodec | None
        self.downlink_state: Any = None
        self.version: int = 0

    def advance(self, n: int = 1) -> int:
        """Bump the version by ``n`` committed rounds; returns it."""
        self.version += int(n)
        return self.version

    def snapshot(self) -> Tuple[int, PyTree]:
        """``(version, params_ref)``: the exact tree clients hold."""
        version = self.version
        dl, state = self.downlink, self.downlink_state
        if dl is not None and state is not None:
            return version, dl.load_tree(state["ref"], like=self.params)
        return version, self.params
