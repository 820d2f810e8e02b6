"""Synthetic same-shape stand-ins for the paper's four LEAF benchmark tasks.

A copy of ``repro.data.synthetic`` (the LM token stream waits for the LM
slice of the port): the generators draw the same numpy stream, so one seed
gives both packages identical datasets.

Each generator produces class/cluster structure so that (a) models can
actually learn (loss decreases, validation accuracy rises above chance) and
(b) clients are *heterogeneous* (label-skew + cluster feature transforms),
which is the regime where the paper's K-decay matters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.data import partition


@dataclass
class FederatedData:
    """Per-client numpy datasets + a global validation split."""
    client_x: List[np.ndarray]
    client_y: List[np.ndarray]
    val_x: np.ndarray
    val_y: np.ndarray
    num_classes: int

    @property
    def num_clients(self) -> int:
        return len(self.client_x)

    @property
    def weights(self) -> np.ndarray:
        """p_c — fraction of all samples owned by client c (Eq. 1)."""
        n = np.array([len(y) for y in self.client_y], dtype=np.float64)
        return n / n.sum()


def _prototype_classification(rng, num_clients, num_classes, feat_shape,
                              samples_per_client, alpha, noise=0.8,
                              n_val=512, cluster_scale=0.35, num_clusters=8):
    """Gaussian class prototypes + Dirichlet label skew + cluster transforms."""
    dim = int(np.prod(feat_shape))
    protos = rng.normal(size=(num_classes, dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    dists = partition.dirichlet_label_skew(rng, num_clients, num_classes, alpha)
    clusters = partition.cluster_assignments(rng, num_clients, num_clusters)
    shifts = rng.normal(size=(num_clusters, dim)).astype(np.float32) * cluster_scale

    cx, cy = [], []
    for c in range(num_clients):
        n = samples_per_client
        y = partition.sample_labels(rng, dists[c], n)
        x = protos[y] + noise * rng.normal(size=(n, dim)).astype(np.float32)
        x = x + shifts[clusters[c]]
        cx.append(x.reshape((n,) + feat_shape).astype(np.float32))
        cy.append(y.astype(np.int32))

    vy = rng.integers(0, num_classes, size=n_val)
    vx = protos[vy] + noise * rng.normal(size=(n_val, dim)).astype(np.float32)
    vx = vx + shifts[rng.integers(0, num_clusters, size=n_val)]  # same mixture
    return FederatedData(cx, cy, vx.reshape((n_val,) + feat_shape).astype(np.float32),
                         vy.astype(np.int32), num_classes)


def make_sent140(rng: np.random.Generator, num_clients=200,
                 samples_per_client=15, vocab=5000) -> FederatedData:
    """Binary sentiment bag-of-words. Positive/negative word buckets per class."""
    pos_words = rng.choice(vocab, size=vocab // 10, replace=False)
    neg_words = rng.choice(vocab, size=vocab // 10, replace=False)
    user_style = rng.dirichlet(np.full(vocab, 0.05), size=num_clients)

    def sample(n, user):
        y = rng.integers(0, 2, size=n)
        x = np.zeros((n, vocab), np.float32)
        for i in range(n):
            words = rng.choice(vocab, size=20, p=user_style[user])
            sentiment = pos_words if y[i] == 1 else neg_words
            words = np.concatenate([words, rng.choice(sentiment, size=8)])
            np.add.at(x[i], words, 1.0)
            x[i] /= max(np.linalg.norm(x[i]), 1e-6)
        return x, y.astype(np.int32)

    cx, cy = [], []
    for c in range(num_clients):
        x, y = sample(samples_per_client, c)
        cx.append(x)
        cy.append(y)
    vx, vy = sample(512, 0)
    return FederatedData(cx, cy, vx, vy, 2)


def make_femnist(rng, num_clients=300, samples_per_client=170,
                 alpha=0.5) -> FederatedData:
    return _prototype_classification(rng, num_clients, 62, (784,),
                                     samples_per_client, alpha)


def make_cifar100(rng, num_clients=100, samples_per_client=100,
                  alpha=0.1) -> FederatedData:
    return _prototype_classification(rng, num_clients, 100, (32, 32, 3),
                                     samples_per_client, alpha, noise=0.5)


def make_shakespeare(rng, num_clients=66, samples_per_client=128, seq_len=80,
                     vocab=79, num_styles=8) -> FederatedData:
    """Markov-chain character streams; each "speaking part" cluster has its
    own transition matrix. x = tokens (S,), y = next tokens (S,)."""
    base = rng.dirichlet(np.full(vocab, 0.3), size=vocab)
    styles = []
    for _ in range(num_styles):
        perturb = rng.dirichlet(np.full(vocab, 0.3), size=vocab)
        styles.append(0.5 * base + 0.5 * perturb)
    clusters = partition.cluster_assignments(rng, num_clients, num_styles)

    def gen(n, T, trans):
        toks = np.zeros((n, T + 1), np.int32)
        toks[:, 0] = rng.integers(0, vocab, size=n)
        for t in range(T):
            p = trans[toks[:, t]]
            cum = p.cumsum(axis=1)
            u = rng.random(n)[:, None]
            toks[:, t + 1] = np.minimum((u > cum).sum(axis=1), vocab - 1)
        return toks[:, :-1], toks[:, 1:]

    cx, cy = [], []
    for c in range(num_clients):
        x, y = gen(samples_per_client, seq_len, styles[clusters[c]])
        cx.append(x)
        cy.append(y.astype(np.int32))
    vx, vy = gen(256, seq_len, styles[0])
    return FederatedData(cx, cy, vx, vy.astype(np.int32), vocab)


PAPER_GENERATORS = {
    "sent140": make_sent140,
    "femnist": make_femnist,
    "cifar100": make_cifar100,
    "shakespeare": make_shakespeare,
}


def make_paper_task(name: str, rng: np.random.Generator, *,
                    num_clients: Optional[int] = None,
                    samples_per_client: Optional[int] = None) -> FederatedData:
    kw = {}
    if num_clients is not None:
        kw["num_clients"] = num_clients
    if samples_per_client is not None:
        kw["samples_per_client"] = samples_per_client
    return PAPER_GENERATORS[name](rng, **kw)
