"""Sweep grids over ``ExperimentSpec`` and program fingerprints
(``repro.api.sweep``, pure Python).

A sweep assignment is the ``with_overrides`` dotted-path syntax with a
comma list on the right-hand side::

    expand_sweep("fed.k0=2,4,8", "transport.name=int8,topk")

expands the cross product (here 3 x 2 = 6 points) into fully-validated
specs, reusing ``with_overrides``'s JSON-first value coercion per element.
Unknown dotted paths / uncoercible values are aggregated into one loud
``SpecValidationError`` — a typo'd sweep axis never silently collapses the
grid.

``spec_program_key(spec)`` fingerprints every spec field that shapes the
round program (model/task, aggregator/server, transport + downlink config,
sampler, chunking, backend placement) and leaves out what only shows up in
the inputs (k0/eta0/rounds/seeds/batch sizes). The fleet runner
(``launch.fleet``) keys each point's bucket programs by it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.api.spec import (ExperimentSpec, SpecValidationError,
                            _parse_scalar)


def parse_sweep(assignments: Sequence[str]) -> "List[Tuple[str, List[Any]]]":
    """``["fed.k0=2,4,8"] -> [("fed.k0", [2, 4, 8])]`` — split each sweep
    assignment into its dotted path and value list (JSON-parsed per
    element; single values become one-element axes). Syntax errors
    aggregate into one ``SpecValidationError``."""
    errors: List[str] = []
    axes: List[Tuple[str, List[Any]]] = []
    for a in assignments:
        if "=" not in a:
            errors.append(f"{a!r}: sweep assignment must look like "
                          f"'section.field=v1,v2,...'")
            continue
        path, _, raw = a.partition("=")
        path = path.strip()
        if len(path.split(".")) != 2:
            errors.append(f"{path!r}: sweep path must be 'section.field' "
                          f"(two components)")
            continue
        values = [_parse_scalar(part) for part in raw.split(",")]
        if any(isinstance(v, str) and not v for v in values):
            errors.append(f"{path}: empty value in sweep list {raw!r}")
            continue
        axes.append((path, values))
    if errors:
        raise SpecValidationError(errors)
    return axes


def sweep_grid(assignments: Sequence[str]
               ) -> List[Tuple[Tuple[str, ...], str]]:
    """Cross product of the sweep axes.

    Returns ``[(override_tuple, label), ...]`` where each
    ``override_tuple`` is a tuple of single-value ``section.field=value``
    assignments (ready for ``with_overrides``) and ``label`` is the short
    human/CSV name (``k0=2|uplink=int8``: last path component + value,
    axes joined by '|')."""
    points: List[Tuple[Tuple[str, ...], str]] = [((), "")]
    for path, values in parse_sweep(assignments):
        fld = path.split(".")[1]
        nxt = []
        for overrides, label in points:
            for v in values:
                ov = f"{path}={_unparse(v)}"
                lab = f"{fld}={_unparse(v)}"
                nxt.append((overrides + (ov,),
                            f"{label}|{lab}" if label else lab))
        points = nxt
    return points


def _unparse(value: Any) -> str:
    """Value back to override-text form (round-trips through json/_coerce)."""
    if isinstance(value, str):
        return value
    import json
    return json.dumps(value)


@dataclass(frozen=True)
class SweepPoint:
    """One expanded grid point: the validated spec plus its provenance."""
    label: str                     # "k0=2|uplink=int8" (CSV/leaderboard id)
    overrides: Tuple[str, ...]     # single-value with_overrides assignments
    spec: ExperimentSpec


def expand_sweep(*assignments: str,
                 base: Optional[ExperimentSpec] = None) -> List[SweepPoint]:
    """Expand sweep assignments over ``base`` (default ``ExperimentSpec()``)
    into validated ``SweepPoint``s — the cross product of all comma lists.

    Every error across every point (unknown dotted path, uncoercible
    value, spec-level validation failure) is aggregated into ONE
    ``SpecValidationError`` so a bad grid fails loudly up front, before
    any point starts compiling."""
    base = base if base is not None else ExperimentSpec()
    grid = sweep_grid(assignments)
    errors: List[str] = []
    points: List[SweepPoint] = []
    for overrides, label in grid:
        try:
            spec = base.with_overrides(*overrides).validate()
        except SpecValidationError as e:
            where = label or "<base>"
            errors.extend(f"[{where}] {msg}" for msg in e.errors)
            continue
        points.append(SweepPoint(label=label or "base",
                                 overrides=overrides, spec=spec))
    if errors:
        # dedupe while keeping order: the same bad axis value appears in
        # every cross-product point it touches
        seen: Dict[str, None] = {}
        for msg in errors:
            seen.setdefault(msg)
        raise SpecValidationError(list(seen))
    return points


def spec_program_key(spec: ExperimentSpec) -> Tuple:
    """Hashable fingerprint of the spec fields that shape the traced
    program (NOT the input signature).

    Included: the model/task identity (decides loss_fn + param tree), the
    aggregation program (aggregator/trim/server/server_lr — python
    constants baked into the trace), the full transport + downlink config,
    the sampler name (fixed cohorts move EF state to per-client slots,
    changing the program), chunking, and the backend placement section.
    Excluded on purpose: k0/eta0/rounds/seeds/batch sizes/cohort sizes —
    those live in the bucket input signature, which is the other half of
    the registry key.

    Mesh fleets must extend this with the slice's device ids."""
    m, d, f = spec.model, spec.data, spec.fed
    t, b, s = spec.transport, spec.backend, spec.sampler
    model_id = (("paper", d.task) if d.kind == "paper"
                else ("lm", m.arch, m.reduced, m.moe_path))
    return (
        "program", model_id,
        ("agg", f.aggregator, f.trim_fraction, f.server_optimizer,
         f.server_lr),
        ("transport", t.name, t.topk_frac, t.downlink, t.ref_store),
        ("sampler", s.name),
        ("chunk", f.cohort_chunk),
        ("backend", b.name, b.strategy, b.groups, b.reduce),
    )
