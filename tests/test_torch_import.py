"""The port stands alone: it imports neither JAX nor the reference package,
its entry points default to the card, and it refuses what it does not
implement."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import FedConfig, get_arch, get_paper_task
from repro_torch.core import (FedAvgTrainer, RuntimeModel, make_round_fn,
                              run_reference_rounds)
from repro_torch.core.engine import AsyncBufferedEngine
from repro_torch.core.engine.trainer import make_eval_fn
from repro_torch.data import make_paper_task
from repro_torch.api import ExperimentSpec, build
from repro_torch.launch import fleet, quickstart, serve, train
from repro_torch.models import registry, small

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_pulls_in_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.bridge, "
            "repro_torch.kernels.ops, repro_torch.kernels._build, "
            "repro_torch.kernels.delta_codec, repro_torch.models.attention, "
            "repro_torch.core.engine.transport, repro_torch.configs, "
            "repro_torch.models.registry, repro_torch.models.transformer, "
            "repro_torch.kernels.flash_attention, repro_torch.distributed, "
            "repro_torch.core.engine.model_store, repro_torch.core.serve, "
            "repro_torch.launch.serve, repro_torch.models.moe, "
            "repro_torch.kernels.moe_gmm, repro_torch.models.ssm, "
            "repro_torch.kernels.ssd_scan, repro_torch.launch.mesh, "
            "repro_torch.core.engine.backends.base, "
            "repro_torch.core.engine.backends.mesh, "
            "repro_torch.kernels.collectives, "
            "repro_torch.core.engine.sampling, repro_torch.data.population, "
            "repro_torch.launch.train_federated_lm, repro_torch.api, "
            "repro_torch.api.spec, repro_torch.api.registries, "
            "repro_torch.api.sweep, repro_torch.api.experiment, "
            "repro_torch.checkpoint, repro_torch.core.theory, "
            "repro_torch.core.engine.policies, repro_torch.launch.train, "
            "repro_torch.launch.quickstart, repro_torch.core.mem, "
            "repro_torch.launch.fleet, repro_torch.core.engine.round, "
            "repro_torch.core.engine.async_buffer, repro_torch.models.encdec, "
            "repro_torch.configs.whisper_tiny, "
            "repro_torch.configs.llava_next_34b\n"
            "from repro_torch.api import ExperimentSpec, build\n"
            "ExperimentSpec.load('examples/specs/local-int8-decayK.json')"
            ".validate()\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120, cwd=SRC.parent)


def test_source_imports_no_jax_and_no_reference():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
        r"|from\s+repro(\.|\s+import)(?!_torch))", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    hits = [f"{f.relative_to(SRC)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def _trainer_no_device(cls=FedAvgTrainer, **fed_kw):
    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=4, samples_per_client=4)
    params = small.init_task_model(0, task, device="cpu")
    return cls(lambda p, b: small.task_loss(p, task, b), params,
               data, FedConfig(clients_per_round=2, **fed_kw),
               RuntimeModel(1.0, task.runtime, 2))


@pytest.mark.parametrize("entry", [
    _trainer_no_device,
    lambda: _trainer_no_device(AsyncBufferedEngine, aggregation="async"),
    lambda: make_round_fn(lambda p, b: None),
    lambda: small.init_task_model(0, get_paper_task("sent140")),
    lambda: run_reference_rounds(None, {}, None, FedConfig(), 1),
    lambda: make_eval_fn(None, None),
    lambda: registry.init(0, get_arch("qwen1.5-0.5b-reduced")),
    lambda: serve.main(["--tokens", "1"]),
    lambda: build(ExperimentSpec()),
    lambda: train.main(["--rounds", "1"]),
    lambda: quickstart.main(["--rounds", "1"]),
    lambda: fleet.main(["--sweep", "fed.k0=2,4", "--rounds", "1"]),
])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


REFUSED = [
    # the wire path is ported: these refuse what the reference refuses
    ("transport", "int8", {"aggregator": "median"}),      # needs linear
    ("downlink", "int8", {"downlink_ref": "q4"}),         # unknown store
    ("downlink_ref", "q8", {}),                           # needs a downlink
    # streaming cohorts are ported (ROADMAP A6): the trainer runs them
    ("cohort_chunk", 2, {}),
    # async is its own engine (A7): the synchronous trainer points there
    ("aggregation", "async", {}),
]
RUNS = {"cohort_chunk"}


@pytest.mark.parametrize("field,value,extra", REFUSED,
                         ids=[f"{f}-{v}" for f, v, _ in REFUSED])
def test_trainer_refuses_unported_config_by_name(field, value, extra):
    """The trainer refuses a configuration it cannot run, naming the field;
    a field in ``RUNS`` was refused before its slice and now runs."""
    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=4, samples_per_client=4)
    params = small.init_task_model(0, task, device="cpu")
    fed = FedConfig(clients_per_round=2, **{field: value, **extra})
    make = lambda: FedAvgTrainer(lambda p, b: small.task_loss(p, task, b),
                                 params, data, fed,
                                 RuntimeModel(1.0, task.runtime, 2),
                                 device="cpu")
    if field in RUNS:
        h = make().run(2)
        assert h.rounds == [1, 2] and np.isfinite(h.train_loss).all()
        return
    with pytest.raises(ValueError, match=field):
        make()


@pytest.mark.parametrize("name", ["whisper-tiny", "llava-next-34b",
                                  "whisper-tiny-reduced"])
def test_get_arch_refuses_unported_families_by_name(name):
    """Every family is ported now: the names the port once refused
    resolve (the encoder-decoder and the vision-language model)."""
    cfg = get_arch(name)
    assert cfg.name == name and cfg.arch_type in ("audio", "vlm")
    assert registry.param_count(cfg) > 0


@pytest.mark.parametrize("name", ["mamba2-780m-reduced", "zamba2-7b-reduced",
                                  "mamba2-780m"])
def test_get_arch_resolves_ssm_families_by_name(name):
    cfg = get_arch(name)
    assert cfg.name == name and cfg.arch_type in ("ssm", "hybrid")
    assert cfg.ssm is not None


def test_model_refuses_non_dense_arch_and_serve_refuses_checkpoint():
    """The serving loop refuses the audio encoder-decoder by name (its
    decode cache needs audio the synthetic traffic lacks), as the
    reference's; the serve launcher refuses a missing checkpoint."""
    from repro_torch.core.engine.model_store import GlobalModelStore
    from repro_torch.core.serve import ServingLoop
    cfg = get_arch("whisper-tiny-reduced")
    params = registry.init(0, cfg, device="cpu")
    assert set(params) >= {"enc_stack", "dec_stack"}
    with pytest.raises(ValueError, match="audio encoder-decoder"):
        ServingLoop(GlobalModelStore(params=params), cfg)
    with pytest.raises(SystemExit, match="checkpoint"):
        serve.main(["--checkpoint", "/nonexistent", "--device", "cpu"])
