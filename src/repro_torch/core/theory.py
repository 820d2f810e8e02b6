"""The paper's theory, executable: Theorem 1 bound, Theorem 2 optimal K_w*,
Corollary 2.1 optimal eta_w*, and the Eq. 10/12 round-form schedules.

These are used (a) by tests that verify the schedules follow from the
theorems (K* ~ w^{-1/3}, eta* ~ w^{-1/2}), and (b) by the strongly-convex
validation experiment that checks Theorem 1's bound actually upper-bounds
measured gradient norms on a quadratic problem.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ProblemConstants:
    """Assumption 1-3 constants for a concrete objective."""
    L: float            # smoothness
    mu: float           # strong convexity
    sigma_sq: float     # sum_c p_c^2 sigma_c^2
    gamma: float        # Gamma = F* - sum_c p_c f_c*   (non-IID-ness)
    g_sq: float         # G^2 = L^2 ||x_1 - x*||^2
    f0: float           # F(x_0)
    f_star: float       # F*
    n_clients: int      # N participating per round

    @property
    def kappa(self) -> float:
        return self.L / self.mu


def theorem1_bound(pc: ProblemConstants, eta: float,
                   ks: Sequence[int]) -> float:
    """Eq. 6: bound on min_t E||grad F(x_bar_t)||^2 after sum(ks) iterations."""
    t_total = float(sum(ks))
    sum_k3 = float(sum(k ** 3 for k in ks))
    sum_k = float(sum(ks))
    kap = pc.kappa
    term1 = 2 * kap * (kap * pc.f0 - pc.f_star) / (eta * t_total)
    drift = (8 + 4 / pc.n_clients) * pc.g_sq * (sum_k3 / sum_k)
    term2 = eta * kap * pc.L * (pc.sigma_sq + 6 * pc.L * pc.gamma + drift)
    return term1 + term2


def optimal_k(pc: ProblemConstants, eta: float, f_current: float,
              comm_time_s: float, horizon_s: float) -> float:
    """Theorem 2 / Eq. 9: optimal fixed K looking forward from now.

    comm_time_s = |x|/D + |x|/U; horizon_s = remaining wall-clock budget W.
    """
    num = pc.kappa * f_current - pc.f_star
    den = 8 * eta ** 2 * pc.L * (1 + 1 / (2 * pc.n_clients)) * pc.g_sq
    return (max(num, 0.0) / den * comm_time_s / horizon_s) ** (1.0 / 3.0)


def optimal_k_rounds(pc: ProblemConstants, eta: float, rounds: int) -> float:
    """Eq. 10: communication-dominated reformulation (K* indep. of beta)."""
    num = pc.kappa * pc.f0 - pc.f_star
    den = 8 * eta ** 2 * pc.L * (1 + 1 / (2 * pc.n_clients)) * pc.g_sq
    return (max(num, 0.0) / den / rounds) ** (1.0 / 3.0)


def optimal_eta(pc: ProblemConstants, k: int, f_current: float,
                comm_time_s: float, beta_s: float, horizon_s: float) -> float:
    """Corollary 2.1 / Eq. 11."""
    z = pc.sigma_sq + 6 * pc.L * pc.gamma + (8 + 4 / pc.n_clients) * pc.g_sq * k ** 2
    num = 2 * pc.kappa * (pc.kappa * f_current - pc.f_star)
    inner = num / (pc.kappa * pc.L * z) * (comm_time_s + beta_s * k) / (horizon_s * k)
    return math.sqrt(max(inner, 0.0))


def optimal_eta_rounds(pc: ProblemConstants, k: int, rounds: int) -> float:
    """Eq. 12."""
    z = pc.sigma_sq + 6 * pc.L * pc.gamma + (8 + 4 / pc.n_clients) * pc.g_sq * k ** 2
    num = 2 * (pc.kappa * pc.f0 - pc.f_star)
    return math.sqrt(max(num / (pc.L * z) / rounds, 0.0))
