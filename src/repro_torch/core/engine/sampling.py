"""ClientSampler — who participates in each round, and with what weights.

The port of ``repro.core.engine.sampling`` (:52-370). Every sampler runs on
the host with numpy and consumes exactly the reference's rng stream, so one
seed draws the same ids and weights in both packages:

  * ``uniform``      — without-replacement uniform draw (the historical
    ``pipeline.sample_clients`` stream);
  * ``weighted``     — draw probability proportional to client dataset size;
  * ``fixed_cohort`` — the same cohort every round, in a stable order. It
    declares ``stateful_cohort``: slot j is always cohort[j], so the trainer
    gives a codec with error feedback one residual slot per client
    (``Transport.with_ef_slots``);
  * ``availability`` — each client online with probability ``p`` this
    round; a shortfall pads the cohort with offline clients at weight 0.
    Populations above ``DENSE_MAX`` take an O(cohort) rejection draw;
  * ``population``   — diurnal availability over a virtual id space: each
    id's timezone phase is a splitmix64 hash of the id, and a round's
    availability follows a cosine day curve between ``base`` and ``peak``.

The reference registers samplers through ``repro.api.registries``; until
the API is ported, ``SAMPLER_FACTORIES`` is the port's name-to-factory
table.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.pipeline import client_weights as _size_weights
from repro_torch.data.pipeline import sample_clients
from repro_torch.data.synthetic import FederatedData


def _stable_unique(a: np.ndarray) -> np.ndarray:
    """Deduplicate keeping first-occurrence order (np.unique sorts)."""
    _, idx = np.unique(a, return_index=True)
    return a[np.sort(idx)]


def splitmix64(ids: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finaliser: int ids -> u64 hashes, so a
    per-client trait (timezone phase) is a pure function of the id."""
    with np.errstate(over="ignore"):
        z = ids.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _hash_unit(ids: np.ndarray) -> np.ndarray:
    """ids -> deterministic floats in [0, 1)."""
    return splitmix64(ids).astype(np.float64) / float(2 ** 64)


class ClientSampler:
    """Protocol. ``round(rng, data, n, round_idx)`` -> (ids (n,), weights
    (n,) f32 summing to 1). ``round_idx`` is the absolute 1-based round
    index; samplers that do not depend on it ignore it."""

    name: str = "base"
    #: True => slot j is the same client every round, so per-client
    #: transport error feedback is sound
    stateful_cohort: bool = False
    #: True => participation rides the weights (zero-weight slots), so the
    #: aggregation must respect weights
    needs_weighted_aggregation: bool = False

    def sample(self, rng: np.random.Generator, data: FederatedData, n: int,
               round_idx: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def weights(self, data: FederatedData, ids: np.ndarray) -> np.ndarray:
        return _size_weights(data, ids)

    def round(self, rng: np.random.Generator, data: FederatedData, n: int,
              round_idx: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        ids = self.sample(rng, data, n, round_idx)
        return ids, self.weights(data, ids)


class UniformSampler(ClientSampler):
    """Uniform without replacement — the historical draw, draw for draw."""

    name = "uniform"

    def sample(self, rng, data, n, round_idx=None):
        return sample_clients(rng, data, n)


class WeightedSampler(ClientSampler):
    """Inclusion probability proportional to client dataset size."""

    name = "weighted"

    def sample(self, rng, data, n, round_idx=None):
        sizes = np.array([len(y) for y in data.client_y], dtype=np.float64)
        return rng.choice(data.num_clients, size=min(n, data.num_clients),
                          replace=False, p=sizes / sizes.sum())


class FixedCohortSampler(ClientSampler):
    """The same clients, in the same slot order, every round (cross-silo).
    ``cohort=None`` means clients ``0..n-1``. Consumes no rng."""

    name = "fixed_cohort"
    stateful_cohort = True

    def __init__(self, cohort: Optional[Sequence[int]] = None):
        self.cohort = None if cohort is None else tuple(int(c) for c in cohort)

    def sample(self, rng, data, n, round_idx=None):
        cohort = self.cohort if self.cohort is not None else tuple(range(n))
        if len(cohort) != n:
            raise ValueError(f"fixed cohort has {len(cohort)} clients, "
                             f"round needs {n}")
        bad = [c for c in cohort if not 0 <= c < data.num_clients]
        if bad:
            raise ValueError(f"cohort ids {bad} out of range "
                             f"[0, {data.num_clients})")
        return np.asarray(cohort, dtype=np.int64)


class AvailabilitySampler(ClientSampler):
    """Bernoulli(p) per-round participation (cross-device churn).

    A shortfall pads the cohort with offline clients at weight 0 (the
    round keeps its shape). A round with nobody online re-draws as a plain
    uniform round; online clients without data get uniform weights."""

    name = "availability"
    needs_weighted_aggregation = True

    #: populations at or below this take the dense Bernoulli draw; above
    #: it, the O(cohort) rejection draw
    DENSE_MAX = 65536

    def __init__(self, prob: float = 0.9):
        if not 0.0 < prob <= 1.0:
            raise ValueError(f"availability prob must be in (0, 1]: {prob}")
        self.prob = float(prob)

    def round(self, rng, data, n, round_idx=None):
        n = min(n, data.num_clients)
        if data.num_clients > self.DENSE_MAX:
            return self._sparse_round(rng, data, n)
        online = np.flatnonzero(rng.random(data.num_clients) < self.prob)
        if len(online) == 0:              # all-offline: re-draw uniformly
            ids = rng.choice(data.num_clients, size=n, replace=False)
            return ids, _size_weights(data, ids)
        if len(online) >= n:
            ids = rng.choice(online, size=n, replace=False)
            return ids, _size_weights(data, ids)
        offline = np.setdiff1d(np.arange(data.num_clients), online,
                               assume_unique=True)
        fill = rng.choice(offline, size=n - len(online), replace=False)
        ids = np.concatenate([online, fill])
        return ids, self._shortfall_weights(data, ids, len(online), n)

    def _sparse_round(self, rng, data, n):
        """O(cohort) draw: candidates drawn uniformly with replacement and
        deduplicated, each kept with prob ``p``; never an array of the
        population's size."""
        N = data.num_clients
        accepted = np.empty(0, np.int64)
        for _ in range(64):
            if len(accepted) >= n:
                break
            need = n - len(accepted)
            m = min(max(int(np.ceil(need / self.prob)) * 2, 32), 1 << 16)
            cand = rng.integers(0, N, size=m)
            keep = cand[rng.random(m) < self.prob]
            accepted = _stable_unique(np.concatenate([accepted, keep]))
        if len(accepted) >= n:
            ids = accepted[:n]
            return ids, _size_weights(data, ids)
        k = len(accepted)
        fill = _draw_distinct(rng, N, n - k, exclude=accepted)
        ids = np.concatenate([accepted, fill])
        if k == 0:                        # all-offline guard, as dense
            return ids, _size_weights(data, ids)
        return ids, self._shortfall_weights(data, ids, k, n)

    @staticmethod
    def _shortfall_weights(data, ids, n_online, n):
        w = np.array([len(data.client_y[c]) for c in ids[:n_online]],
                     np.float64)
        if w.sum() <= 0:                  # online but data-less: uniform
            w = np.ones_like(w)
        weights = np.zeros(n, np.float32)
        weights[:n_online] = (w / w.sum()).astype(np.float32)
        return weights

    def sample(self, rng, data, n, round_idx=None):
        return self.round(rng, data, n, round_idx)[0]


def _draw_distinct(rng: np.random.Generator, N: int, k: int,
                   exclude: np.ndarray) -> np.ndarray:
    """k distinct ids from [0, N) avoiding ``exclude`` — O(k) for k << N."""
    out = np.empty(0, np.int64)
    for _ in range(64):
        if len(out) >= k:
            break
        cand = rng.integers(0, N, size=max(2 * (k - len(out)), 16))
        cand = cand[~np.isin(cand, exclude)]
        out = _stable_unique(np.concatenate([out, cand]))
    if len(out) < k:                      # tiny N fallback: exact set diff
        rest = np.setdiff1d(np.arange(N), np.concatenate([exclude, out]),
                            assume_unique=False)
        out = np.concatenate([out, rest])
    return out[:k]


class PopulationSampler(ClientSampler):
    """Diurnal availability over a virtual id space of ``population`` ids.

    At absolute round r the time of day is ``(r % day_rounds) /
    day_rounds`` and client c is available with

        p_c(r) = base + (peak - base) * (1 + cos(2π(tod - phase_c))) / 2,

    ``phase_c = splitmix64(c) / 2^64``. Candidates are drawn uniformly and
    accepted with prob ``p_c(r) / peak``; a shortfall pads at weight 0, as
    ``availability``."""

    name = "population"
    needs_weighted_aggregation = True

    def __init__(self, population: int = 0, peak: float = 0.9,
                 base: float = 0.05, day_rounds: int = 24):
        if population < 0:
            raise ValueError(f"population must be >= 0: {population}")
        if not 0.0 < peak <= 1.0:
            raise ValueError(f"peak availability must be in (0, 1]: {peak}")
        if not 0.0 < base <= peak:
            raise ValueError(f"base availability must be in (0, peak]: "
                             f"{base}")
        if day_rounds < 1:
            raise ValueError(f"day_rounds must be >= 1: {day_rounds}")
        self.population = int(population)
        self.peak = float(peak)
        self.base = float(base)
        self.day_rounds = int(day_rounds)

    def availability(self, ids: np.ndarray, round_idx: int) -> np.ndarray:
        """Per-id availability at absolute round ``round_idx``."""
        tod = (int(round_idx) % self.day_rounds) / self.day_rounds
        phase = _hash_unit(np.asarray(ids))
        day = 0.5 * (1.0 + np.cos(2.0 * np.pi * (tod - phase)))
        return self.base + (self.peak - self.base) * day

    def round(self, rng, data, n, round_idx=None):
        N = self.population or data.num_clients
        n = min(n, N)
        r = 1 if round_idx is None else int(round_idx)
        accepted = np.empty(0, np.int64)
        for _ in range(64):
            if len(accepted) >= n:
                break
            need = n - len(accepted)
            # mean acceptance is >= base/peak; oversample against it
            m = min(max(int(np.ceil(need * self.peak / self.base)) * 2, 32),
                    1 << 16)
            cand = rng.integers(0, N, size=m)
            keep = cand[rng.random(m) * self.peak
                        < self.availability(cand, r)]
            accepted = _stable_unique(np.concatenate([accepted, keep]))
        if len(accepted) >= n:
            ids = accepted[:n]
            return ids, _size_weights(data, ids)
        k = len(accepted)
        fill = _draw_distinct(rng, N, n - k, exclude=accepted)
        ids = np.concatenate([accepted, fill])
        if k == 0:
            return ids, _size_weights(data, ids)
        return ids, AvailabilitySampler._shortfall_weights(data, ids, k, n)

    def sample(self, rng, data, n, round_idx=None):
        return self.round(rng, data, n, round_idx)[0]


#: name -> factory(*, fed): ``fed`` (a FedConfig) supplies the cohort and
#: the availability settings
SAMPLER_FACTORIES = {
    "uniform": lambda *, fed=None: UniformSampler(),
    "weighted": lambda *, fed=None: WeightedSampler(),
    "fixed_cohort": lambda *, fed=None: FixedCohortSampler(
        cohort=getattr(fed, "cohort", None)),
    "availability": lambda *, fed=None: AvailabilitySampler(
        prob=getattr(fed, "availability", 0.9)),
    "population": lambda *, fed=None: PopulationSampler(
        population=getattr(fed, "population", 0),
        peak=getattr(fed, "availability", 0.9),
        base=getattr(fed, "base_availability", 0.05),
        day_rounds=getattr(fed, "day_rounds", 24)),
}
SAMPLERS = tuple(SAMPLER_FACTORIES)


def get_sampler(name, *, fed=None) -> ClientSampler:
    """A sampler by name (a ``ClientSampler`` instance passes through);
    ``fed`` supplies its configuration."""
    if isinstance(name, ClientSampler):
        return name
    if name not in SAMPLER_FACTORIES:
        raise ValueError(f"unknown sampler {name!r}; known: {SAMPLERS}")
    return SAMPLER_FACTORIES[name](fed=fed)


def make_sampler(fed) -> ClientSampler:
    """The trainer's entry point: build the FedConfig's sampler."""
    return get_sampler(getattr(fed, "sampler", "uniform") or "uniform",
                       fed=fed)
