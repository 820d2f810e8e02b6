"""ExperimentSpec — the frozen, serializable description of one experiment
(``repro.api.spec``; the same sections, fields, JSON and error strings).

One JSON artifact pins everything a run needs: model, data, federated
schedule, sampler, transport, backend, runtime model and serving.
``build(spec)`` (``repro_torch.api.experiment``) turns it into a ready
``FederatedExperiment``; the spec rides inside every checkpoint so
``restore`` rebuilds the exact trainer.

Contracts:

  * ``from_json(spec.to_json()) == spec`` — exact dataclass round-trip.
  * ``validate()`` raises one ``SpecValidationError`` carrying ALL
    problems (dotted paths included), not just the first.
  * ``with_overrides("fed.k0=4", "transport.name=int8")`` — dotted-path
    overrides with field-type coercion; values parse as JSON first
    (``fed.cohort=[0,1,2]`` works) and fall back to raw strings.
  * unknown JSON keys are aggregated errors, never silently dropped —
    schema drift in saved specs is loud.

``validate`` accepts and rejects what the reference's does, the mesh's
sequential strategy with ``cohort_chunk`` or with async aggregation
included.
"""
from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class SpecValidationError(ValueError):
    """All spec problems at once: ``errors`` is a list of 'path: message'."""

    def __init__(self, errors: List[str]):
        self.errors = list(errors)
        msg = "\n  - ".join(self.errors)
        super().__init__(f"invalid ExperimentSpec ({len(self.errors)} "
                         f"error(s)):\n  - {msg}")


# ---------------------------------------------------------------------------
# leaf specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelSpec:
    """Model selection; used when ``data.kind == 'lm'`` (the paper-task data
    kinds carry their own small models)."""
    arch: str = "qwen1.5-0.5b"     # configs.ARCHS key
    reduced: bool = True           # CPU-scale same-family variant
    moe_path: str = "dense"        # MoE dispatch path for loss_fn


@dataclass(frozen=True)
class DataSpec:
    kind: str = "lm"               # 'lm' (synthetic LM tokens) | 'paper'
    task: str = ""                 # paper task name for kind='paper'
    clients: int = 24              # total client population
    samples_per_client: int = 64
    seq_len: int = 64              # kind='lm' sequence length
    seed: int = 0                  # data-generation rng (not the run seed)


@dataclass(frozen=True)
class FedSpec:
    """The paper's algorithm knobs (mirrors ``configs.base.FedConfig``)."""
    rounds: int = 100
    clients_per_round: int = 16
    k0: int = 16
    eta0: float = 0.1
    batch_size: int = 32
    k_schedule: str = "fixed"
    eta_schedule: str = "fixed"
    k_quantize: bool = False
    k_grid0: Optional[int] = None  # explicit quantize_k grid anchor (None =
                                   # k0); fleet sweeps pin one anchor so
                                   # points with different k0 share bucket
                                   # shapes + executables (DESIGN.md §12)
    k_min: int = 1
    loss_window: int = 100
    plateau_patience: int = 50
    step_decay_factor: float = 10.0
    server_optimizer: str = "avg"
    server_lr: float = 1.0
    aggregator: str = "mean"
    trim_fraction: float = 0.1
    bucket_rounds: int = 8
    feedback_bucket_rounds: int = 1
    prefetch: bool = True
    eval_every: int = 0            # 0 = no evaluation pass
    cohort_chunk: Optional[int] = None   # streaming slab size C (§11);
                                         # None = dense vmapped cohort
    # --- async buffered aggregation (DESIGN.md §13) ---
    aggregation: str = "sync"            # sync (round-synchronous, default,
                                         # program-identical) | async
                                         # (FedBuff-style buffered folding)
    buffer_size: Optional[int] = None    # async: apply after this many
                                         # arrivals (None = clients_per_round)
    staleness_weight: str = "constant"   # async: constant | inv | poly
    max_staleness: Optional[int] = None  # async: drop arrivals staler than
                                         # this many versions (None = keep)
    seed: int = 0


@dataclass(frozen=True)
class SamplerSpec:
    name: str = "uniform"          # uniform|weighted|fixed_cohort|
                                   # availability|population (§11)
    availability: float = 0.9      # Bernoulli online prob (availability);
                                   # peak diurnal prob (population)
    cohort: Optional[Tuple[int, ...]] = None   # fixed_cohort membership
    population: int = 0            # population sampler: virtual client-id
                                   # space (10^6+); 0 = data.clients
    day_rounds: int = 24           # population: diurnal period in rounds
    base_availability: float = 0.05  # population: trough diurnal prob


@dataclass(frozen=True)
class TransportSpec:
    name: str = "none"             # none|int8|int8x2|topk (DESIGN.md §8)
    topk_frac: float = 0.1
    downlink: str = "none"         # broadcast codec: same names plus
                                   # "adaptive" (§8.6, §10)
    ref_store: str = "f32"         # server-held downlink ref/residual
                                   # store: f32 | q8 (§10.3)


@dataclass(frozen=True)
class BackendSpec:
    name: str = "local"            # local|mesh (DESIGN.md §7)
    strategy: str = "parallel"     # mesh client fan-out
    groups: int = 1                # sequential-strategy client groups
    reduce: str = "flat"           # flat | grouped two-tier psum (§11)


@dataclass(frozen=True)
class ServeSpec:
    """Serve-while-training (DESIGN.md §14): hot-swap the global model
    into a live decode service between rounds / buffer applies."""
    every: int = 0                 # tick the serving loop every N rounds
                                   # (sync) / buffer applies (async);
                                   # 0 = no serving
    qps: float = 0.0               # sustained decode queries/sec the server
                                   # answers alongside training (runtime
                                   # cost model only; 0 = free serving)
    query_ms: float = 1.0          # modelled per-query decode seconds*1e3;
                                   # rho = qps * query_ms/1e3 must be < 1
    batch: int = 2                 # traffic replay batch per tick
    prompt_len: int = 4
    tokens: int = 8                # greedy-decoded tokens per query
    traffic: str = "synthetic"     # TRAFFIC_REGISTRY stream name
    seed: int = 0                  # traffic stream seed


@dataclass(frozen=True)
class RuntimeSpec:
    """Eq. 3-5 constants (mirrors ``configs.base.RuntimeModelConfig``)."""
    download_mbps: float = 20.0
    upload_mbps: float = 5.0
    beta_seconds: float = 0.1
    bytes_per_param: int = 4
    heterogeneity: float = 0.0     # lognormal straggler sigma (0 = Eq. 5)


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExperimentSpec:
    model: ModelSpec = field(default_factory=ModelSpec)
    data: DataSpec = field(default_factory=DataSpec)
    fed: FedSpec = field(default_factory=FedSpec)
    sampler: SamplerSpec = field(default_factory=SamplerSpec)
    transport: TransportSpec = field(default_factory=TransportSpec)
    backend: BackendSpec = field(default_factory=BackendSpec)
    runtime: RuntimeSpec = field(default_factory=RuntimeSpec)
    serve: ServeSpec = field(default_factory=ServeSpec)

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        errors: List[str] = []
        kwargs: Dict[str, Any] = {}
        sections = {f.name: f for f in dataclasses.fields(cls)}
        for key in d:
            if key not in sections:
                errors.append(f"{key}: unknown section (expected one of "
                              f"{sorted(sections)})")
        for name, f in sections.items():
            sub = d.get(name)
            if sub is None:
                continue
            if not isinstance(sub, dict):
                errors.append(f"{name}: expected an object, got "
                              f"{type(sub).__name__}")
                continue
            sub_cls = f.default_factory
            sub_fields = {sf.name: sf for sf in dataclasses.fields(sub_cls)}
            sub_kwargs = {}
            for k, v in sub.items():
                if k not in sub_fields:
                    errors.append(f"{name}.{k}: unknown field (expected one "
                                  f"of {sorted(sub_fields)})")
                    continue
                try:
                    sub_kwargs[k] = _coerce(v, sub_fields[k].type,
                                            f"{name}.{k}")
                except ValueError as e:
                    errors.append(str(e))
            if not errors:
                kwargs[name] = sub_cls(**sub_kwargs)
        if errors:
            raise SpecValidationError(errors)
        return cls(**kwargs)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    # ------------------------------------------------------------------
    # dotted-path overrides
    # ------------------------------------------------------------------
    def with_overrides(self, *assignments: str) -> "ExperimentSpec":
        """``spec.with_overrides("fed.k0=4", "transport.name=int8")``.

        Each assignment is ``section.field=value``; values are parsed as
        JSON when possible (numbers, booleans, null, lists) and coerced to
        the field's declared type. All bad assignments are reported in one
        ``SpecValidationError``."""
        errors: List[str] = []
        updates: Dict[str, Dict[str, Any]] = {}
        sections = {f.name: f for f in dataclasses.fields(self)}
        for a in assignments:
            if "=" not in a:
                errors.append(f"{a!r}: override must look like "
                              f"'section.field=value'")
                continue
            path, _, raw = a.partition("=")
            parts = path.strip().split(".")
            if len(parts) != 2:
                errors.append(f"{path!r}: override path must be "
                              f"'section.field' (two components)")
                continue
            sec, fld = parts
            if sec not in sections:
                errors.append(f"{sec!r}: unknown section (expected one of "
                              f"{sorted(sections)})")
                continue
            sub = getattr(self, sec)
            sub_fields = {sf.name: sf for sf in dataclasses.fields(sub)}
            if fld not in sub_fields:
                errors.append(f"{sec}.{fld}: unknown field (expected one of "
                              f"{sorted(sub_fields)})")
                continue
            val = _parse_override_value(raw)
            try:
                updates.setdefault(sec, {})[fld] = _coerce(
                    val, sub_fields[fld].type, f"{sec}.{fld}")
            except ValueError as e:
                msg = str(e)
                if isinstance(val, list) and "," in raw and \
                        not raw.strip().startswith("["):
                    msg += (" — a comma list on a scalar field is sweep "
                            "syntax: expand it into one spec per value "
                            "with repro_torch.api.sweep.expand_sweep(...) or "
                            "launch with --sweep")
                errors.append(msg)
        if errors:
            raise SpecValidationError(errors)
        new_sections = {sec: dataclasses.replace(getattr(self, sec), **kw)
                        for sec, kw in updates.items()}
        return dataclasses.replace(self, **new_sections)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def validate(self) -> "ExperimentSpec":
        """Raise ``SpecValidationError`` with EVERY problem, or return self."""
        errors: List[str] = []
        m, d, f = self.model, self.data, self.fed
        s, t, b, r = self.sampler, self.transport, self.backend, self.runtime
        sv = self.serve

        if d.kind not in ("lm", "paper"):
            errors.append(f"data.kind: {d.kind!r} not in ('lm', 'paper')")
        elif d.kind == "paper":
            from repro_torch.configs.paper_tasks import PAPER_TASKS
            if d.task not in PAPER_TASKS:
                errors.append(f"data.task: {d.task!r} not in "
                              f"{sorted(PAPER_TASKS)}")
        else:
            from repro_torch.configs import ARCHS
            if m.arch not in ARCHS:
                errors.append(f"model.arch: {m.arch!r} not a known "
                              f"architecture (see configs.ARCHS)")
        for name, v in (("data.clients", d.clients),
                        ("data.samples_per_client", d.samples_per_client),
                        ("data.seq_len", d.seq_len),
                        ("fed.rounds", f.rounds),
                        ("fed.clients_per_round", f.clients_per_round),
                        ("fed.k0", f.k0), ("fed.batch_size", f.batch_size),
                        ("fed.k_min", f.k_min),
                        ("fed.bucket_rounds", f.bucket_rounds),
                        ("fed.feedback_bucket_rounds",
                         f.feedback_bucket_rounds),
                        ("backend.groups", b.groups)):
            if v < 1:
                errors.append(f"{name}: must be >= 1, got {v}")
        if f.clients_per_round > d.clients:
            errors.append(f"fed.clients_per_round: {f.clients_per_round} "
                          f"exceeds data.clients ({d.clients})")
        if f.eta0 <= 0:
            errors.append(f"fed.eta0: must be > 0, got {f.eta0}")
        if f.eval_every < 0:
            errors.append(f"fed.eval_every: must be >= 0, got {f.eval_every}")

        if f.k_grid0 is not None:
            if f.k_grid0 < 1:
                errors.append(f"fed.k_grid0: must be >= 1, got {f.k_grid0}")
            elif not f.k_quantize:
                errors.append("fed.k_grid0: a pinned quantize-grid anchor "
                              "only applies when fed.k_quantize=true")

        from repro_torch.core.schedules import ETA_SCHEDULES, K_SCHEDULES
        if f.k_schedule not in K_SCHEDULES:
            errors.append(f"fed.k_schedule: {f.k_schedule!r} not in "
                          f"{K_SCHEDULES}")
        if f.eta_schedule not in ETA_SCHEDULES:
            errors.append(f"fed.eta_schedule: {f.eta_schedule!r} not in "
                          f"{ETA_SCHEDULES}")

        from repro_torch.api.registries import (AGGREGATOR_REGISTRY,
                                                BACKEND_REGISTRY,
                                                SAMPLER_REGISTRY,
                                                SERVER_OPTIMIZER_REGISTRY,
                                                TRANSPORT_REGISTRY)
        for reg, path, name in (
                (AGGREGATOR_REGISTRY, "fed.aggregator", f.aggregator),
                (SERVER_OPTIMIZER_REGISTRY, "fed.server_optimizer",
                 f.server_optimizer),
                (TRANSPORT_REGISTRY, "transport.name", t.name),
                (TRANSPORT_REGISTRY, "transport.downlink", t.downlink),
                (SAMPLER_REGISTRY, "sampler.name", s.name),
                (BACKEND_REGISTRY, "backend.name", b.name)):
            if name not in reg:
                errors.append(f"{path}: {reg._unknown_message(name)}")

        from repro_torch.core.engine.backends.base import LINEAR_AGGREGATORS
        if (t.name in TRANSPORT_REGISTRY and t.name != "none"
                and f.aggregator not in LINEAR_AGGREGATORS):
            errors.append(f"transport.name: compressed codec {t.name!r} "
                          f"requires a linear aggregator "
                          f"{LINEAR_AGGREGATORS}, got {f.aggregator!r}")
        if not 0.0 < t.topk_frac <= 1.0:
            errors.append(f"transport.topk_frac: must be in (0, 1], got "
                          f"{t.topk_frac}")
        if t.name == "adaptive":
            errors.append("transport.name: 'adaptive' is a downlink-only "
                          "codec — set transport.downlink='adaptive' "
                          "instead")
        if t.ref_store not in ("f32", "q8"):
            errors.append(f"transport.ref_store: must be 'f32' or 'q8', "
                          f"got {t.ref_store!r}")
        elif t.ref_store != "f32" and t.downlink == "none":
            errors.append("transport.ref_store: a quantised ref store "
                          "requires a downlink codec "
                          "(transport.downlink != 'none')")
        if not 0.0 < s.availability <= 1.0:
            errors.append(f"sampler.availability: must be in (0, 1], got "
                          f"{s.availability}")
        if s.name == "availability" and f.aggregator not in LINEAR_AGGREGATORS:
            errors.append("sampler.name: availability shortfall padding "
                          "needs a weight-respecting (linear) aggregator, "
                          f"got {f.aggregator!r}")
        if s.cohort is not None:
            if s.name != "fixed_cohort":
                errors.append("sampler.cohort: only meaningful for "
                              f"sampler.name='fixed_cohort', got {s.name!r}")
            elif len(s.cohort) != f.clients_per_round:
                errors.append(f"sampler.cohort: {len(s.cohort)} clients, "
                              f"fed.clients_per_round is "
                              f"{f.clients_per_round}")
            elif any(not 0 <= c < d.clients for c in s.cohort):
                errors.append(f"sampler.cohort: ids must be in "
                              f"[0, {d.clients})")
        if s.name == "population":
            if f.aggregator not in LINEAR_AGGREGATORS:
                errors.append("sampler.name: population sampling weights "
                              "the diurnal cohort — needs a linear "
                              f"aggregator, got {f.aggregator!r}")
            pop = s.population if s.population else d.clients
            if f.clients_per_round > pop:
                errors.append(f"fed.clients_per_round: "
                              f"{f.clients_per_round} exceeds the "
                              f"population ({pop})")
        if s.population < 0:
            errors.append(f"sampler.population: must be >= 0, got "
                          f"{s.population}")
        elif s.population and s.name != "population":
            errors.append("sampler.population: only meaningful for "
                          f"sampler.name='population', got {s.name!r}")
        if s.day_rounds < 1:
            errors.append(f"sampler.day_rounds: must be >= 1, got "
                          f"{s.day_rounds}")
        if not 0.0 < s.base_availability <= 1.0:
            errors.append(f"sampler.base_availability: must be in (0, 1], "
                          f"got {s.base_availability}")
        if f.cohort_chunk is not None:
            if f.cohort_chunk < 1:
                errors.append(f"fed.cohort_chunk: must be >= 1, got "
                              f"{f.cohort_chunk}")
            if f.aggregator not in LINEAR_AGGREGATORS:
                errors.append("fed.cohort_chunk: streaming slabs fold into "
                              "a running weighted sum — robust aggregators "
                              f"(got {f.aggregator!r}) need the whole "
                              f"cohort stack; use {LINEAR_AGGREGATORS} or "
                              "drop cohort_chunk")
            if t.downlink != "none":
                errors.append("fed.cohort_chunk: chunked streaming rounds "
                              "do not compose with a downlink codec yet "
                              "(the per-slab broadcast would re-encode per "
                              "slab) — set transport.downlink='none'")
            if b.name == "mesh" and b.strategy == "sequential":
                errors.append("fed.cohort_chunk: the mesh sequential "
                              "strategy already streams clients through a "
                              "scan — cohort_chunk only applies to the "
                              "parallel (vmapped) cohort")
        from repro_torch.api.registries import (AGGREGATION_REGISTRY,
                                                STALENESS_WEIGHT_REGISTRY)
        if f.aggregation not in AGGREGATION_REGISTRY:
            errors.append(f"fed.aggregation: "
                          f"{AGGREGATION_REGISTRY._unknown_message(f.aggregation)}")
        if f.staleness_weight not in STALENESS_WEIGHT_REGISTRY:
            errors.append(f"fed.staleness_weight: "
                          f"{STALENESS_WEIGHT_REGISTRY._unknown_message(f.staleness_weight)}")
        if f.aggregation == "async":
            if f.aggregator not in LINEAR_AGGREGATORS:
                errors.append("fed.aggregation: async buffered folding is a "
                              "streaming weighted sum — robust aggregators "
                              f"(got {f.aggregator!r}) need the whole cohort "
                              f"stack at once; use {LINEAR_AGGREGATORS} or "
                              "fed.aggregation='sync'")
            if f.cohort_chunk is not None:
                errors.append("fed.cohort_chunk: chunked streaming cohorts "
                              "are a round-synchronous execution shape — the "
                              "async engine already streams arrivals one at "
                              "a time; drop fed.cohort_chunk")
            if b.name == "mesh" and b.strategy == "sequential":
                errors.append("backend.strategy: the mesh sequential scan "
                              "folds a whole synchronous cohort — async "
                              "dispatch groups are ragged; use "
                              "backend.strategy='parallel'")
            if t.downlink != "none":
                errors.append("transport.downlink: async clients start from "
                              "skewed global versions, so the single "
                              "broadcast-reference state machine cannot "
                              "encode one delta for all of them yet — set "
                              "transport.downlink='none'")
            if s.name == "fixed_cohort":
                errors.append("sampler.name: 'fixed_cohort' pins one client "
                              "per slot, but async redispatches ragged "
                              "groups of freed slots — use 'uniform' or "
                              "'weighted'")
            if f.buffer_size is not None:
                if f.buffer_size < 1:
                    errors.append(f"fed.buffer_size: must be >= 1, got "
                                  f"{f.buffer_size}")
                elif f.buffer_size > f.clients_per_round:
                    errors.append(f"fed.buffer_size: {f.buffer_size} exceeds "
                                  f"fed.clients_per_round "
                                  f"({f.clients_per_round}) — the buffer "
                                  f"can never fill past the in-flight "
                                  f"cohort; lower fed.buffer_size or raise "
                                  f"fed.clients_per_round")
            if f.max_staleness is not None and f.max_staleness < 0:
                errors.append(f"fed.max_staleness: must be >= 0, got "
                              f"{f.max_staleness}")
        else:
            for name, v in (("fed.buffer_size", f.buffer_size),
                            ("fed.max_staleness", f.max_staleness)):
                if v is not None:
                    errors.append(f"{name}: only meaningful for "
                                  f"fed.aggregation='async', got "
                                  f"aggregation={f.aggregation!r}")
            if f.staleness_weight != "constant":
                errors.append(f"fed.staleness_weight: "
                              f"{f.staleness_weight!r} only applies to "
                              f"fed.aggregation='async' (sync rounds have "
                              f"staleness 0 by construction)")
        if b.strategy not in ("parallel", "sequential"):
            errors.append(f"backend.strategy: {b.strategy!r} not in "
                          f"('parallel', 'sequential')")
        if b.reduce not in ("flat", "grouped"):
            errors.append(f"backend.reduce: {b.reduce!r} not in "
                          f"('flat', 'grouped')")
        for name, v in (("runtime.download_mbps", r.download_mbps),
                        ("runtime.upload_mbps", r.upload_mbps),
                        ("runtime.beta_seconds", r.beta_seconds)):
            if v <= 0:
                errors.append(f"{name}: must be > 0, got {v}")
        if sv.every < 0:
            errors.append(f"serve.every: must be >= 0, got {sv.every}")
        if sv.qps < 0:
            errors.append(f"serve.qps: must be >= 0, got {sv.qps}")
        if sv.query_ms <= 0:
            errors.append(f"serve.query_ms: must be > 0, got {sv.query_ms}")
        for name, v in (("serve.batch", sv.batch),
                        ("serve.prompt_len", sv.prompt_len),
                        ("serve.tokens", sv.tokens)):
            if v < 1:
                errors.append(f"{name}: must be >= 1, got {v}")
        if sv.every > 0 and d.kind != "lm":
            errors.append("serve.every: the serving loop decodes through "
                          "the LM cache path — only data.kind='lm' runs "
                          f"can serve, got {d.kind!r}")
        if sv.qps > 0 and sv.every == 0:
            errors.append("serve.qps: a serve load on the runtime model "
                          "without a serving loop (serve.every=0) models a "
                          "service that never answers — set serve.every >= 1")
        rho = sv.qps * sv.query_ms / 1e3
        if rho >= 1.0:
            errors.append(f"serve.qps: utilisation rho = qps * query_ms/1e3 "
                          f"= {rho:.3f} >= 1 — the server spends every "
                          f"second decoding and training never progresses; "
                          f"lower serve.qps or serve.query_ms")
        from repro_torch.api.registries import TRAFFIC_REGISTRY
        if sv.traffic not in TRAFFIC_REGISTRY:
            errors.append(f"serve.traffic: "
                          f"{TRAFFIC_REGISTRY._unknown_message(sv.traffic)}")
        if errors:
            raise SpecValidationError(errors)
        return self


# ---------------------------------------------------------------------------
# type coercion for json / override values
# ---------------------------------------------------------------------------

def _parse_override_value(raw: str) -> Any:
    """Parse an override's right-hand side: JSON first, then a bare comma
    list (``sampler.cohort=0,1,2`` == ``[0,1,2]``), then a raw string. The
    comma form is what ``--sweep`` grids are written in; on a tuple field it
    coerces directly, on a scalar field the caller reports it as sweep
    syntax."""
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        pass
    text = raw.strip()
    if "," in text and not text.startswith(("[", "{")):
        return [_parse_scalar(part) for part in text.split(",")]
    return text


def _parse_scalar(text: str) -> Any:
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text.strip()


def _coerce(value: Any, ftype: Any, path: str) -> Any:
    """Coerce a parsed JSON value to a dataclass field's declared type."""
    if isinstance(ftype, str):                 # from __future__ annotations
        ftype = {"int": int, "float": float, "bool": bool, "str": str,
                 "Optional[int]": Optional[int],
                 "Optional[Tuple[int, ...]]": Optional[Tuple[int, ...]],
                 }.get(ftype, ftype)
    origin = typing.get_origin(ftype)
    if origin is typing.Union:                 # Optional[...]
        if value is None:
            return None
        inner = [a for a in typing.get_args(ftype) if a is not type(None)]
        return _coerce(value, inner[0], path)
    if origin in (tuple, Tuple):
        if not isinstance(value, (list, tuple)):
            raise ValueError(f"{path}: expected a list, got {value!r}")
        args = typing.get_args(ftype)
        elem = args[0] if args else None
        return tuple(_coerce(v, elem, path) for v in value)
    if ftype is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
        raise ValueError(f"{path}: expected a boolean, got {value!r}")
    if ftype is int:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{path}: expected an integer, got {value!r}")
        if isinstance(value, float) and not value.is_integer():
            raise ValueError(f"{path}: expected an integer, got {value!r}")
        return int(value)
    if ftype is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{path}: expected a number, got {value!r}")
        return float(value)
    if ftype is str:
        if not isinstance(value, str):
            raise ValueError(f"{path}: expected a string, got {value!r}")
        return value
    return value
