"""The paper's FedAvg runtime model (§3.2, Eq. 3-5) and compute accounting.

A copy of ``repro.core.runtime_model``, the serve-while-training stretch
included.

Nominal per-round wall-clock for client c:
    W_r^c = |x|/D^c + K_r * beta^c + |x|/U^c          (Eq. 3)
The server waits for the straggler:
    W_r = max_c W_r^c                                  (Eq. 4)
Homogeneous-client total over R rounds:
    W = R(|x|/D + |x|/U) + beta * sum_r K_r            (Eq. 5)

An optional heterogeneous straggler model (lognormal client speed spread)
serves sensitivity studies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import RuntimeModelConfig


@dataclass
class RoundCost:
    wall_clock_s: float
    sgd_steps: int
    uplink_mbit: float
    downlink_mbit: float
    #: decode queries the server answered during this round's wall time
    #: (serve while training); 0.0 without serving
    serve_queries: float = 0.0


class RuntimeModel:
    def __init__(self, model_size_mbit: float, cfg: RuntimeModelConfig,
                 clients_per_round: int = 1, heterogeneity: float = 0.0,
                 seed: int = 0, uplink_compression: float = 1.0,
                 downlink_compression: float = 1.0,
                 serve_qps: float = 0.0, serve_query_s: float = 0.0):
        """heterogeneity: sigma of lognormal speed multipliers per sampled
        client, applied to the client's whole round time (compute and both
        wire legs); 0 reproduces the paper's homogeneous Eq. 5.
        ``uplink_compression`` / ``downlink_compression``: ratios by which a
        codec shrinks each wire leg (1.0 = the paper's uncompressed |x|).
        ``serve_qps`` / ``serve_query_s``: the decode traffic the server
        answers while it trains (rho = qps * query_s of every wall second)."""
        self.size = model_size_mbit
        self.cfg = cfg
        self.n = clients_per_round
        self.het = heterogeneity
        self.uplink_compression = float(uplink_compression)
        self.downlink_compression = float(downlink_compression)
        #: {level: ratio} of the adaptive downlink codec, set by the
        #: trainer and read by ``round_cost(..., downlink_level=...)``;
        #: None charges every round the fixed ``downlink_compression``
        self.downlink_level_ratios = None
        # round coordination runs on the 1 - rho of each wall second left
        # after serving: the utilisation stretch 1/(1 - rho) on the clock
        self.serve_qps = float(serve_qps)
        self.serve_query_s = float(serve_query_s)
        rho = self.serve_qps * self.serve_query_s
        if rho >= 1.0:
            raise ValueError(
                f"serve utilisation rho = serve_qps * serve_query_s = "
                f"{rho:.3f} >= 1: the server spends every second answering "
                f"queries and training never progresses — lower serve.qps "
                f"or serve.query_ms")
        self._serve_stretch = 1.0 / (1.0 - rho) if rho > 0 else 1.0
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)

    @property
    def uplink_mbit_per_client(self) -> float:
        return self.size / self.uplink_compression

    @property
    def downlink_mbit_per_client(self) -> float:
        return self.size / self.downlink_compression

    def comm_time(self) -> float:
        """Per-round communication term, heterogeneity-free (Eq. 5 mean)."""
        return (self.downlink_mbit_per_client / self.cfg.download_mbps
                + self.uplink_mbit_per_client / self.cfg.upload_mbps)

    def _leg_mbit(self, downlink_level: Optional[int] = None
                  ) -> Tuple[float, float]:
        """(uplink, downlink) encoded mbit per client for one round, with
        the adaptive downlink's per-level charge applied."""
        up = self.uplink_mbit_per_client
        down = self.downlink_mbit_per_client
        if self.downlink_level_ratios is not None and \
                downlink_level is not None and downlink_level >= 0:
            if downlink_level == 0:
                down = 0.0
            else:
                ratio = self.downlink_level_ratios.get(
                    downlink_level, self.downlink_compression)
                down = self.size / float(ratio)
        return up, down

    def _base_seconds(self, k: int,
                      downlink_level: Optional[int] = None) -> float:
        """Eq. 3 for the nominal (speed-multiplier 1.0) client."""
        up, down = self._leg_mbit(downlink_level)
        return (down / self.cfg.download_mbps
                + k * self.cfg.beta_seconds
                + up / self.cfg.upload_mbps)

    def draw_client_times(self, round_idx: Optional[int],
                          client_ids: Sequence[int], k: int, *,
                          downlink_level: Optional[int] = None) -> np.ndarray:
        """Seeded per-client round durations (Eq. 3 x lognormal multiplier).

        ``round_idx=None``: stream mode, one draw per client off the model's
        own rng. ``round_idx`` given: counter mode, each multiplier drawn
        from ``default_rng([seed, round_idx, client_id])``."""
        ids = np.asarray(client_ids, dtype=np.int64)
        base = self._base_seconds(k, downlink_level)
        if self.het <= 0:
            return np.full(ids.shape[0], base, dtype=np.float64)
        if round_idx is None:
            mult = self._rng.lognormal(0.0, self.het, size=ids.shape[0])
        else:
            mult = np.array([
                np.random.default_rng(
                    [self._seed, int(round_idx), int(c)]
                ).lognormal(0.0, self.het) for c in ids])
        return base * mult

    def round_cost(self, k: int, downlink_level: Optional[int] = None
                   ) -> RoundCost:
        """Eq. 3/4: straggler max over the round's client draws.
        ``downlink_level`` (read only when ``downlink_level_ratios`` is
        set): 0 ships no broadcast, a level in the map charges its ratio,
        -1/None the configured ratio."""
        up, down = self._leg_mbit(downlink_level)
        if self.het > 0:
            times = self.draw_client_times(None, np.arange(self.n), k,
                                           downlink_level=downlink_level)
            wall = float(np.max(times))
        else:
            wall = self._base_seconds(k, downlink_level)
        wall *= self._serve_stretch
        return RoundCost(wall_clock_s=wall,
                         sgd_steps=k * self.n,
                         uplink_mbit=up * self.n,
                         downlink_mbit=down * self.n,
                         serve_queries=self.serve_qps * wall)

    def total_time(self, ks: Sequence[int]) -> float:
        """Eq. 5 (homogeneous)."""
        r = len(ks)
        return r * self.comm_time() + self.cfg.beta_seconds * float(np.sum(ks))

    def total_sgd_steps(self, ks: Sequence[int]) -> int:
        return int(np.sum(ks)) * self.n

    def relative_sgd_steps(self, ks: Sequence[int], k0: int) -> float:
        """Table 4: schedule compute relative to K-eta-fixed."""
        return float(np.sum(ks)) / (k0 * len(ks))
