"""Eq. 15 rolling global-loss estimator + validation plateau detector.

Clients report f_c(x_r, xi_{c,0}) — the training loss of the *global* model on
their first local minibatch (an unbiased estimate of F(x_r), one float per
client per round, negligible communication). Because only a small non-IID
fraction of clients participates per round, the per-round mean is high
variance; the paper smooths with a window of s=100 rounds.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional


class LossTracker:
    def __init__(self, window: int = 100):
        self.window = window
        self._buf: Deque[float] = deque(maxlen=window)

    def push(self, round_mean_loss: float) -> None:
        self._buf.append(float(round_mean_loss))

    @property
    def full(self) -> bool:
        return len(self._buf) >= self.window

    def value(self) -> float:
        """Rolling mean over the last s rounds (Eq. 15)."""
        if not self._buf:
            raise ValueError("no losses observed yet")
        return sum(self._buf) / len(self._buf)


class PlateauDetector:
    """Plateau when the best validation error hasn't improved by more than
    ``min_delta`` for ``patience`` consecutive observations."""

    def __init__(self, patience: int = 50, min_delta: float = 1e-4):
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.stale = 0
        self.plateaued = False

    def push(self, val_error: float) -> None:
        v = float(val_error)
        if self.best is None or v < self.best - self.min_delta:
            self.best = v
            self.stale = 0
        else:
            self.stale += 1
            if self.stale >= self.patience:
                self.plateaued = True
