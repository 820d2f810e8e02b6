"""K_r and eta_r decay schedules — the paper's contribution (Table 3).

| schedule     | K_r                          | eta_r                  |
|--------------|------------------------------|------------------------|
| dsgd         | 1                            | eta0                   |
| fixed        | K0                           | eta0                   |
| K_r-rounds   | ceil(K0 / r^(1/3))   (Eq.10) | eta0                   |
| K_r-error    | ceil(K0 * (F_r/F0)^(1/3)) (13)| eta0                  |
| K_r-step     | K0/10 once val plateaus      | eta0                   |
| eta_r-rounds | K0                           | eta0 / sqrt(r) (Eq.12) |
| eta_r-error  | K0                           | eta0*sqrt(F_r/F0) (14) |
| eta_r-step   | K0                           | eta0/10 once plateaued |

Beyond-paper: ``cosine`` K decay and ``quantize_k`` (snap K_r to a geometric
grid to bound the number of distinct compiled round functions).
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.configs.base import FedConfig
from repro_torch.core.loss_tracker import LossTracker, PlateauDetector

K_SCHEDULES = ("fixed", "dsgd", "rounds", "error", "step", "cosine")
ETA_SCHEDULES = ("fixed", "rounds", "error", "step")


def quantize_k(k: int, k0: int, ratio: float = 1.35) -> int:
    """Snap k to the geometric grid {k0, k0/ratio, k0/ratio^2, ...}."""
    if k >= k0:
        return k0
    if k <= 1:
        return 1
    # grid level closest from below
    level = math.floor(math.log(k0 / k) / math.log(ratio) + 1e-9)
    return max(1, int(round(k0 / ratio ** level)))


class DecayController:
    """Produces (K_r, eta_r) per round and ingests the feedback signals the
    schedules need: first-step client losses (Eq. 15 rolling estimate) and
    validation metrics (plateau detection for the -step heuristic)."""

    def __init__(self, fed: FedConfig):
        if fed.k_schedule not in K_SCHEDULES:
            raise ValueError(f"k_schedule {fed.k_schedule!r} not in {K_SCHEDULES}")
        if fed.eta_schedule not in ETA_SCHEDULES:
            raise ValueError(f"eta_schedule {fed.eta_schedule!r} not in {ETA_SCHEDULES}")
        self.fed = fed
        self.tracker = LossTracker(window=fed.loss_window)
        self.plateau = PlateauDetector(patience=fed.plateau_patience)
        self._f0: Optional[float] = None

    # ---------------- feedback ----------------
    def observe_round_losses(self, mean_first_step_loss: float) -> None:
        """Feed (1/N) sum_c f_c(x_r, xi_c0) for the just-finished round."""
        self.tracker.push(mean_first_step_loss)
        if self._f0 is None:
            self._f0 = float(mean_first_step_loss)

    def observe_validation(self, val_error: float) -> None:
        self.plateau.push(val_error)

    # ---------------- checkpointing ----------------
    def state_dict(self) -> dict:
        """Feedback state under the legacy checkpoint keys (both engines'
        ``meta["ctrl"]`` payloads delegate here, DESIGN.md §14)."""
        return {"f0": self._f0, "window": list(self.tracker._buf),
                "plateau": [self.plateau.best, self.plateau.stale,
                            self.plateau.plateaued]}

    def load_state_dict(self, c: dict) -> None:
        self.tracker._buf.clear()
        for v in c["window"]:
            self.tracker.push(v)
        self._f0 = c["f0"]
        best, stale, plateaued = c["plateau"]
        self.plateau.best = best
        self.plateau.stale = int(stale)
        self.plateau.plateaued = bool(plateaued)

    # ---------------- queries ----------------
    def _error_ratio(self) -> float:
        """F_r / F_0 with the Eq. 15 rolling window; 1.0 until warm."""
        if self._f0 is None or not self.tracker.full:
            return 1.0
        f_r = self.tracker.value()
        return max(min(f_r / max(self._f0, 1e-12), 1.0), 0.0)

    def k_for_round(self, r: int) -> int:
        fed = self.fed
        s = fed.k_schedule
        if s == "dsgd":
            return 1
        if s == "fixed":
            k = fed.k0
        elif s == "rounds":
            k = math.ceil(fed.k0 / r ** (1.0 / 3.0))
        elif s == "error":
            k = math.ceil(fed.k0 * self._error_ratio() ** (1.0 / 3.0))
        elif s == "step":
            k = max(int(fed.k0 / fed.step_decay_factor), 1) \
                if self.plateau.plateaued else fed.k0
        elif s == "cosine":
            t = min(r / max(fed.rounds, 1), 1.0)
            k = math.ceil(fed.k_min + 0.5 * (fed.k0 - fed.k_min)
                          * (1 + math.cos(math.pi * t)))
        else:
            raise AssertionError(s)
        k = max(min(k, fed.k0), fed.k_min)
        if fed.k_quantize:
            # the grid anchor is fed.k0 unless a sweep pins an explicit
            # k_grid0: fleet points with different k0 but one shared anchor
            # snap to IDENTICAL grid values, so their bucket shapes — and
            # hence their AOT executables — coincide (DESIGN.md §12)
            k = quantize_k(k, getattr(fed, "k_grid0", None) or fed.k0)
        return k

    def eta_for_round(self, r: int) -> float:
        fed = self.fed
        s = fed.eta_schedule
        if s == "fixed":
            return fed.eta0
        if s == "rounds":
            return fed.eta0 / math.sqrt(r)
        if s == "error":
            return fed.eta0 * math.sqrt(self._error_ratio())
        if s == "step":
            return fed.eta0 / fed.step_decay_factor if self.plateau.plateaued \
                else fed.eta0
        raise AssertionError(s)


def schedule_preview(fed: FedConfig, rounds: int):
    """K_r trajectory for loss-free schedules (rounds/cosine/fixed/dsgd)."""
    ctrl = DecayController(fed)
    return [ctrl.k_for_round(r) for r in range(1, rounds + 1)]
