"""String-keyed plugin registries: the extension points of the port's
public API (``repro.api.registries``).

Every pluggable axis of the engine (aggregators, server optimizers, wire
transports, client samplers, execution backends, the aggregation policy,
the async buffer's staleness weights and the serving loop's traffic)
resolves names through one of the registries below, so a new variant is
one ``register_*`` call away from every entry point that speaks strings:
``ExperimentSpec``, ``FedAvgTrainer``/``RoundEngine`` and
``launch/train.py``.

A registry stores *factories*: callables that build the component from
keyword configuration. All factories should accept ``**kw`` so new
configuration knobs never break old plugins.

Builtins register themselves when their defining module imports. Each
registry knows that module and imports it lazily on first lookup, so
``available()`` is complete whichever of ``repro_torch.api`` or
``repro_torch.core.engine`` was imported first (this module imports
nothing of the engine at module scope).

Unknown names raise ``KeyError`` (and ``ValueError``) with a did-you-mean
suggestion::

    >>> get_aggregator("meen")
    KeyError: "unknown aggregator 'meen'. Did you mean 'mean'? ..."
"""
from __future__ import annotations

import difflib
import importlib
from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class UnknownNameError(KeyError, ValueError):
    """Unknown registry name. Subclasses BOTH KeyError (mapping semantics)
    and ValueError (the engine's historical ``get_*`` contract), so callers
    catching either keep working."""

    def __str__(self) -> str:          # KeyError.__str__ repr()s the message
        return self.args[0] if self.args else ""


class Registry:
    """Name -> factory mapping with lazy builtin loading.

    ``register(name)`` works as a decorator or a direct call; registering an
    existing name overwrites it (latest wins — this is how users shadow a
    builtin with their own implementation).
    """

    def __init__(self, kind: str, builtins_module: Optional[str] = None):
        self.kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}
        self._builtins_module = builtins_module
        self._loaded = builtins_module is None
        self._loading = False

    # ------------------------------------------------------------------
    def _ensure_builtins(self) -> None:
        # _loaded flips only on success: a transient import failure surfaces
        # to every caller instead of poisoning the registry into reporting
        # builtin names as unknown; _loading guards re-entrant lookups while
        # the builtins module registers itself
        if self._loaded or self._loading:
            return
        self._loading = True
        try:
            importlib.import_module(self._builtins_module)
            self._loaded = True
        finally:
            self._loading = False

    # ------------------------------------------------------------------
    def register(self, name: str, factory: Optional[Callable] = None):
        """``register("x", f)`` or ``@register("x")`` above a factory."""
        if not isinstance(name, str) or not name:
            raise TypeError(f"{self.kind} name must be a non-empty string, "
                            f"got {name!r}")
        if factory is None:
            def deco(f):
                self._entries[name] = f
                return f
            return deco
        self._entries[name] = factory
        return factory

    def get(self, name: str) -> Callable[..., Any]:
        self._ensure_builtins()
        try:
            return self._entries[name]
        except KeyError:
            raise UnknownNameError(self._unknown_message(name)) from None

    def _unknown_message(self, name) -> str:
        avail = self.available()
        hint = ""
        close = difflib.get_close_matches(str(name), avail, n=1, cutoff=0.5)
        if close:
            hint = f" Did you mean {close[0]!r}?"
        return (f"unknown {self.kind} {name!r}.{hint} "
                f"Available: {', '.join(avail) or '(none registered)'}")

    def available(self) -> Tuple[str, ...]:
        self._ensure_builtins()
        return tuple(sorted(self._entries))

    def __contains__(self, name: str) -> bool:
        self._ensure_builtins()
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.available())

    def __repr__(self) -> str:
        return f"Registry({self.kind}: {', '.join(self.available())})"


# ---------------------------------------------------------------------------
# the registries (builtins live next to the protocols they implement)
# ---------------------------------------------------------------------------

#: factory(*, trim_fraction, **kw) -> Aggregator  ((N,...) stack, (N,) w -> (...))
AGGREGATOR_REGISTRY = Registry("aggregator", "repro_torch.core.engine.aggregators")

#: factory(**kw) -> ServerOptimizer (init/step NamedTuple)
SERVER_OPTIMIZER_REGISTRY = Registry("server_optimizer",
                                     "repro_torch.core.engine.server")

#: factory(*, topk_frac, **kw) -> Transport | None (None = identity wire path)
TRANSPORT_REGISTRY = Registry("transport", "repro_torch.core.engine.transport")

#: factory(*, fed, **kw) -> ClientSampler (fed: configs.base.FedConfig)
SAMPLER_REGISTRY = Registry("sampler", "repro_torch.core.engine.sampling")

#: factory(*, strategy, groups, **kw) -> ExecutionBackend
BACKEND_REGISTRY = Registry("backend", "repro_torch.core.engine.backends")

#: AggregationPolicy axis: factory(**kw) -> policy(loss_fn, init_params,
#: data, fed, runtime, *, eval_fn, backend, device, **kw) -> trainer
#: ("sync" -> FedAvgTrainer; "async" -> AsyncBufferedEngine)
AGGREGATION_REGISTRY = Registry("aggregation",
                                "repro_torch.core.engine.policies")

#: factory(**kw) -> Callable[[staleness int], float] — the async buffer's
#: per-arrival contribution scale
STALENESS_WEIGHT_REGISTRY = Registry("staleness_weight",
                                     "repro_torch.core.engine.policies")

#: factory(*, cfg, batch, prompt_len, seed, **kw) -> Callable[[tick int],
#: np.ndarray (batch, prompt_len) int prompt ids] — the ServingLoop's
#: deterministic query stream
TRAFFIC_REGISTRY = Registry("traffic", "repro_torch.core.serve.loop")

register_aggregator = AGGREGATOR_REGISTRY.register
register_server_optimizer = SERVER_OPTIMIZER_REGISTRY.register
register_transport = TRANSPORT_REGISTRY.register
register_sampler = SAMPLER_REGISTRY.register
register_backend = BACKEND_REGISTRY.register
register_aggregation = AGGREGATION_REGISTRY.register
register_staleness_weight = STALENESS_WEIGHT_REGISTRY.register
register_traffic = TRAFFIC_REGISTRY.register

REGISTRIES = {r.kind: r for r in (AGGREGATOR_REGISTRY,
                                  SERVER_OPTIMIZER_REGISTRY,
                                  TRANSPORT_REGISTRY, SAMPLER_REGISTRY,
                                  BACKEND_REGISTRY, AGGREGATION_REGISTRY,
                                  STALENESS_WEIGHT_REGISTRY,
                                  TRAFFIC_REGISTRY)}
