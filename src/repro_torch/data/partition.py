"""Non-IID client partitioners.

Real FL data (LEAF) is unavailable offline; we generate synthetic datasets
with controlled heterogeneity. Two partition mechanisms cover the paper's
tasks:

* ``dirichlet_label_skew`` — per-client class distribution ~ Dir(alpha);
  alpha -> 0 gives one-class clients (max drift), alpha -> inf gives IID.
  (CIFAR100's label-partition in the paper is the alpha->0 extreme.)
* ``cluster_skew`` — clients are grouped into latent "writer/speaker"
  clusters with cluster-specific feature transforms (FEMNIST's
  writer-grouping, Shakespeare's speaking-part grouping).
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_label_skew(rng: np.random.Generator, num_clients: int,
                         num_classes: int, alpha: float) -> np.ndarray:
    """Per-client label distributions, shape (num_clients, num_classes)."""
    return rng.dirichlet(np.full(num_classes, alpha), size=num_clients)


def sample_labels(rng: np.random.Generator, dist: np.ndarray, n: int) -> np.ndarray:
    """Draw n labels from one client's label distribution."""
    return rng.choice(dist.shape[-1], size=n, p=dist)


def cluster_assignments(rng: np.random.Generator, num_clients: int,
                        num_clusters: int) -> np.ndarray:
    return rng.integers(0, num_clusters, size=num_clients)


def heterogeneity_gamma(client_opts: List[float], weights: np.ndarray,
                        global_opt: float) -> float:
    """Paper's Gamma = F* - sum_c p_c f_c*: quantifies non-IID-ness."""
    return float(global_opt - np.sum(weights * np.asarray(client_opts)))
