"""FederatedExperiment: build, run and resume an ExperimentSpec
(``repro.api.experiment``).

``build(spec)`` is the one composition root: it turns the declarative spec
into data, model, loss, runtime model, backend, sampler and a configured
``FedAvgTrainer``, on the card unless ``device="cpu"``. The construction is
deterministic in the spec: two ``build`` calls on equal specs train
bitwise alike.

Checkpoints written by ``FederatedExperiment.save`` embed the spec, so
``FederatedExperiment.restore(path)`` rebuilds the exact trainer and loads
its state, from a checkpoint of either package.

``fed.aggregation="async"`` builds an ``AsyncBufferedEngine`` (through
``AGGREGATION_REGISTRY``), ``fed.cohort_chunk`` a trainer that streams
each round in slabs, and ``serve.every`` attaches a ``ServingLoop`` that
the trainer ticks while it trains. ``backend.name="mesh"`` runs either
mesh strategy; ``backend.strategy="sequential"`` with ``backend.groups``
loops each group's clients one at a time.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from repro_torch.api.spec import ExperimentSpec
from repro_torch.configs.base import FedConfig, RuntimeModelConfig
from repro_torch.device import DeviceLike, resolve_device

PyTree = Any


def _make_fed_config(spec: ExperimentSpec) -> FedConfig:
    f, s, t = spec.fed, spec.sampler, spec.transport
    return FedConfig(
        total_clients=spec.data.clients,
        clients_per_round=f.clients_per_round,
        rounds=f.rounds, k0=f.k0, eta0=f.eta0, batch_size=f.batch_size,
        k_schedule=f.k_schedule, eta_schedule=f.eta_schedule,
        loss_window=f.loss_window, plateau_patience=f.plateau_patience,
        step_decay_factor=f.step_decay_factor, k_min=f.k_min,
        k_quantize=f.k_quantize, k_grid0=f.k_grid0,
        server_optimizer=f.server_optimizer,
        server_lr=f.server_lr, seed=f.seed,
        aggregator=f.aggregator, trim_fraction=f.trim_fraction,
        transport=t.name, topk_frac=t.topk_frac, downlink=t.downlink,
        downlink_ref=t.ref_store,
        sampler=s.name, cohort=s.cohort, availability=s.availability,
        population=s.population, day_rounds=s.day_rounds,
        base_availability=s.base_availability,
        bucket_rounds=f.bucket_rounds,
        feedback_bucket_rounds=f.feedback_bucket_rounds,
        prefetch=f.prefetch, cohort_chunk=f.cohort_chunk,
        aggregation=f.aggregation, buffer_size=f.buffer_size,
        staleness_weight=f.staleness_weight, max_staleness=f.max_staleness)


def _make_backend(spec: ExperimentSpec, device):
    from repro_torch.core.engine.backends import get_backend
    b = spec.backend
    return get_backend(b.name, strategy=b.strategy, groups=b.groups,
                       reduce=b.reduce, device=device)


def _build_task(spec: ExperimentSpec, device):
    """(data, loss_fn, params, model_size_mbit, label) for the spec's data
    kind; params are drawn from ``spec.fed.seed`` on ``device`` (torch's
    stream, not ``jax.random``'s: the same spec gives other initial values
    than the reference's, so cross-framework runs share params through a
    checkpoint)."""
    if spec.data.kind == "paper":
        from repro_torch.configs import get_paper_task
        from repro_torch.data import make_paper_task
        from repro_torch.models import small
        task = get_paper_task(spec.data.task)
        data = make_paper_task(spec.data.task,
                               np.random.default_rng(spec.data.seed),
                               num_clients=spec.data.clients,
                               samples_per_client=spec.data.samples_per_client)
        loss_fn = lambda p, b: small.task_loss(p, task, b)
        params = small.init_task_model(spec.fed.seed, task, device=device)
        return data, loss_fn, params, task.model_size_mb, task.name

    from repro_torch.configs import get_arch
    from repro_torch.data import make_lm_clients
    from repro_torch.models import registry
    cfg = get_arch(spec.model.arch)
    if spec.model.reduced:
        cfg = cfg.reduced()
    data = make_lm_clients(np.random.default_rng(spec.data.seed),
                           num_clients=spec.data.clients,
                           vocab=cfg.vocab_size, seq_len=spec.data.seq_len,
                           samples_per_client=spec.data.samples_per_client)
    model_loss = registry.loss_fn(cfg, moe_path=spec.model.moe_path)
    loss_fn = lambda p, b: model_loss(p, {"tokens": b["x"]})
    params = registry.init(spec.fed.seed, cfg, device=device)
    n_params = registry.param_count(cfg)
    size_mbit = n_params * spec.runtime.bytes_per_param * 8 / 1e6
    return data, loss_fn, params, size_mbit, cfg.name


class FederatedExperiment:
    """A built experiment: spec + trainer.

    Not constructed directly: use ``build(spec)`` or
    ``FederatedExperiment.restore(checkpoint_path)``."""

    def __init__(self, spec: ExperimentSpec, trainer, label: str):
        self.spec = spec
        self.trainer = trainer
        self.label = label

    @property
    def history(self):
        return self.trainer.history

    @property
    def params(self) -> PyTree:
        return self.trainer.params

    def _eval_every(self) -> Optional[int]:
        """``fed.eval_every == 0`` means no evaluation pass (the
        scheduler's ``None``)."""
        return self.spec.fed.eval_every if self.spec.fed.eval_every > 0 \
            else None

    def run(self, rounds: Optional[int] = None, *, verbose: bool = False):
        """Run the schedule (default: ``spec.fed.rounds``)."""
        return self.trainer.run(rounds if rounds is not None
                                else self.spec.fed.rounds,
                                eval_every=self._eval_every(),
                                verbose=verbose)

    def resume(self, checkpoint: str, rounds: Optional[int] = None, *,
               verbose: bool = False):
        """Restore the trainer's state from ``checkpoint`` and continue
        from the first round not run (bitwise the uninterrupted run)."""
        self.trainer.restore_state(checkpoint)
        return self.trainer.run(rounds if rounds is not None
                                else self.spec.fed.rounds,
                                eval_every=self._eval_every(),
                                verbose=verbose, resume=True)

    def save(self, path: str) -> None:
        """Full-state checkpoint with the spec embedded."""
        self.trainer.save_state(path, extra_meta={"spec": self.spec.as_dict()})

    @classmethod
    def restore(cls, path: str, *, device: DeviceLike = None
                ) -> "FederatedExperiment":
        """Rebuild the experiment from the spec inside a checkpoint (of
        either package) and load its state. Continue with
        ``exp.trainer.run(rounds, resume=True)``."""
        with open(os.path.join(path, "meta.json")) as f:
            meta: Dict[str, Any] = json.load(f)
        if "spec" not in meta:
            raise ValueError(f"checkpoint {path!r} has no embedded spec "
                             f"(written by a pre-spec save_state?)")
        exp = build(ExperimentSpec.from_dict(meta["spec"]), device=device)
        exp.trainer.restore_state(path)
        return exp


def build(spec: ExperimentSpec, *, backend=None, registry=None,
          program_key=None, device: DeviceLike = None) -> FederatedExperiment:
    """Validate the spec and compose the experiment it describes.

    ``backend``: an ``ExecutionBackend`` overriding the spec's backend
    section (it brings its device; the fleet runner passes each packed
    point its slice). ``registry``: a shared ``ExecutableRegistry``, so
    experiments share bucket programs; ``program_key`` defaults to
    ``sweep.spec_program_key(spec)`` when a registry is given. ``device``:
    where the experiment runs (default ``cuda``)."""
    from repro_torch.api.registries import AGGREGATION_REGISTRY
    from repro_torch.core.engine.trainer import make_eval_fn
    from repro_torch.core.runtime_model import RuntimeModel

    spec.validate()
    if registry is not None and program_key is None:
        from repro_torch.api.sweep import spec_program_key
        program_key = spec_program_key(spec)
    if backend is None:
        device = resolve_device(device)
        backend = _make_backend(spec, device)
    else:
        device = backend.device
    data, loss_fn, params, size_mbit, label = _build_task(spec, device)
    if (spec.sampler.name == "population" and spec.sampler.population
            and spec.sampler.population != data.num_clients):
        # a virtual id space over the materialised clients
        from repro_torch.data import PopulationView
        data = PopulationView(data, spec.sampler.population)
    fed = _make_fed_config(spec)
    r = spec.runtime
    runtime = RuntimeModel(
        size_mbit,
        RuntimeModelConfig(download_mbps=r.download_mbps,
                           upload_mbps=r.upload_mbps,
                           beta_seconds=r.beta_seconds,
                           bytes_per_param=r.bytes_per_param),
        fed.clients_per_round, heterogeneity=r.heterogeneity,
        serve_qps=spec.serve.qps, serve_query_s=spec.serve.query_ms / 1e3)
    eval_fn = (make_eval_fn(loss_fn, data, device=device)
               if spec.fed.eval_every > 0 else None)
    policy = AGGREGATION_REGISTRY.get(fed.aggregation)()
    trainer = policy(loss_fn, params, data, fed, runtime, eval_fn=eval_fn,
                     backend=backend, device=device, registry=registry,
                     program_key=program_key)
    if spec.serve.every > 0:
        # serve while training: the loop reads the trainer's store; the
        # trainer ticks it between rounds and changes nothing it computes
        from repro_torch.configs import get_arch
        from repro_torch.core.serve import ServingLoop
        cfg = get_arch(spec.model.arch)
        if spec.model.reduced:
            cfg = cfg.reduced()
        trainer.serving = ServingLoop(
            trainer.store, cfg, batch=spec.serve.batch,
            prompt_len=spec.serve.prompt_len, tokens=spec.serve.tokens,
            moe_path=spec.model.moe_path, traffic=spec.serve.traffic,
            seed=spec.serve.seed)
        trainer.serve_every = spec.serve.every
    return FederatedExperiment(spec, trainer, label)
