"""repro_torch.api — the port's public, declarative experiment API
(``repro.api``).

    from repro_torch.api import ExperimentSpec, build

    spec = ExperimentSpec.load("examples/specs/local-int8-decayK.json")
    spec = spec.with_overrides("fed.rounds=50", "transport.name=topk")
    exp = build(spec)            # -> FederatedExperiment, on the card
    history = exp.run()
    exp.save("runs/ckpt")        # spec embedded: restore() rebuilds exactly

Extension points are string-keyed registries (``register_aggregator``,
``register_transport``, ``register_server_optimizer``, ``register_sampler``,
``register_backend``) — everything that resolves components by name
(``ExperimentSpec``, ``FedAvgTrainer``, ``launch/train.py``) looks the name
up there, so a registered plugin is usable everywhere at once.

Attribute access is lazy (PEP 562): importing ``repro_torch.api`` pulls in
no engine module until a name is actually used.
"""
from __future__ import annotations

_SPEC_NAMES = ("ExperimentSpec", "ModelSpec", "DataSpec", "FedSpec",
               "SamplerSpec", "TransportSpec", "BackendSpec", "RuntimeSpec",
               "SpecValidationError")
_EXPERIMENT_NAMES = ("FederatedExperiment", "build")
_SWEEP_NAMES = ("SweepPoint", "expand_sweep", "sweep_grid", "parse_sweep",
                "spec_program_key")
_REGISTRY_NAMES = ("Registry", "REGISTRIES", "UnknownNameError",
                   "AGGREGATOR_REGISTRY", "SERVER_OPTIMIZER_REGISTRY",
                   "TRANSPORT_REGISTRY", "SAMPLER_REGISTRY",
                   "BACKEND_REGISTRY",
                   "register_aggregator", "register_server_optimizer",
                   "register_transport", "register_sampler",
                   "register_backend")

__all__ = list(_SPEC_NAMES + _EXPERIMENT_NAMES + _SWEEP_NAMES
               + _REGISTRY_NAMES)


def __getattr__(name):
    if name in _SPEC_NAMES:
        from repro_torch.api import spec as _m
    elif name in _EXPERIMENT_NAMES:
        from repro_torch.api import experiment as _m
    elif name in _SWEEP_NAMES:
        from repro_torch.api import sweep as _m
    elif name in _REGISTRY_NAMES:
        from repro_torch.api import registries as _m
    else:
        raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
    return getattr(_m, name)


def __dir__():
    return sorted(__all__)
