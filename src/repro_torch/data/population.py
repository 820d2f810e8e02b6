"""PopulationView — a virtual 10^6+ client-id space over a base dataset.

A copy of ``repro.data.population``. Population-scale simulation
(DESIGN.md §11) needs client ids far beyond what fits as materialised
per-client datasets. ``PopulationView`` presents
``population`` virtual clients over a real ``FederatedData``: virtual id i
resolves to base client ``i % base.num_clients`` lazily at access time, so
the view itself is O(1) state — no list of a million references, no copies.

Only the *sampled cohort* is ever touched (the population samplers draw
O(cohort) ids per round), so batch building, weight computation and
everything downstream stay O(cohort) regardless of the population size.
Unknown attributes (val split, num_classes, ...) delegate to the base
dataset.
"""
from __future__ import annotations

import numpy as np


class _ModView:
    """Lazy ``seq[i % len(seq)]`` sequence of virtual length ``n``."""

    __slots__ = ("_base", "_n")

    def __init__(self, base, n: int):
        self._base = base
        self._n = int(n)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        i = int(i)
        if not -self._n <= i < self._n:
            raise IndexError(f"client id {i} out of range [0, {self._n})")
        return self._base[i % len(self._base)]

    def __iter__(self):
        # O(population) by definition — only here for debugging/small views;
        # the samplers and pipeline never iterate the full population.
        return (self[i] for i in range(self._n))


class PopulationView:
    """``population`` virtual clients over ``base`` (see module docstring).

    Duck-types ``FederatedData``: ``client_x``/``client_y`` are lazy
    modular views, ``num_clients`` is the virtual population, everything
    else delegates to the base dataset."""

    def __init__(self, base, population: int):
        if population < 1:
            raise ValueError(f"population must be >= 1: {population}")
        if base.num_clients < 1:
            raise ValueError("base dataset has no clients")
        self._base = base
        self._population = int(population)
        self.client_x = _ModView(base.client_x, self._population)
        self.client_y = _ModView(base.client_y, self._population)

    @property
    def num_clients(self) -> int:
        return self._population

    @property
    def base(self):
        return self._base

    @property
    def weights(self) -> np.ndarray:
        raise NotImplementedError(
            "PopulationView.weights would materialise an O(population) "
            "array; use pipeline.client_weights over the sampled cohort")

    def __getattr__(self, name):
        return getattr(self._base, name)

    def __repr__(self) -> str:
        return (f"PopulationView(population={self._population}, "
                f"base_clients={self._base.num_clients})")
