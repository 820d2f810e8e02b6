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

from repro_torch.configs import FedConfig, get_paper_task
from repro_torch.core import (FedAvgTrainer, RuntimeModel, make_round_fn,
                              run_reference_rounds)
from repro_torch.core.engine.trainer import make_eval_fn
from repro_torch.data import make_paper_task
from repro_torch.models import small

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_pulls_in_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.bridge, "
            "repro_torch.kernels.ops, repro_torch.kernels._build, "
            "repro_torch.kernels.delta_codec, repro_torch.models.attention, "
            "repro_torch.core.engine.transport\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_source_imports_no_jax_and_no_reference():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
        r"|from\s+repro(\.|\s+import)(?!_torch))", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    hits = [f"{f.relative_to(SRC)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def _trainer_no_device():
    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=4, samples_per_client=4)
    params = small.init_task_model(0, task, device="cpu")
    return FedAvgTrainer(lambda p, b: small.task_loss(p, task, b), params,
                         data, FedConfig(clients_per_round=2),
                         RuntimeModel(1.0, task.runtime, 2))


@pytest.mark.parametrize("entry", [
    _trainer_no_device,
    lambda: make_round_fn(lambda p, b: None),
    lambda: small.init_task_model(0, get_paper_task("sent140")),
    lambda: run_reference_rounds(None, {}, None, FedConfig(), 1),
    lambda: make_eval_fn(None, None),
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
    ("cohort_chunk", 2, {}), ("aggregation", "async", {}),
    ("sampler", "fixed_cohort", {}),
]


@pytest.mark.parametrize("field,value,extra", REFUSED,
                         ids=[f"{f}-{v}" for f, v, _ in REFUSED])
def test_trainer_refuses_unported_config_by_name(field, value, extra):
    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=4, samples_per_client=4)
    params = small.init_task_model(0, task, device="cpu")
    fed = FedConfig(clients_per_round=2, **{field: value, **extra})
    with pytest.raises(ValueError, match=field):
        FedAvgTrainer(lambda p, b: small.task_loss(p, task, b), params, data,
                      fed, RuntimeModel(1.0, task.runtime, 2), device="cpu")
