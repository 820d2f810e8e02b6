"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same narrow models and small data for both packages, LM trainers built
from one spec in both packages, tree comparison by key path, and the
one-torch-thread pin (``one_torch_thread``: a test file imports it, and
the import makes it apply to every test of that file)."""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_paper_task as jax_task
from repro.data import synthetic as jsynthetic
from repro.models import small as jsmall
from repro_torch import bridge
from repro_torch.data import make_paper_task
from repro_torch.optim import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's test ops are small: with several test workers on one
    machine, torch's intra-op threads oversubscribe the cores (an async
    test ran ~170x slower, and a gmm accumulation test ~80x). One thread a
    worker, restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return bridge.params_from_jax(tree, device="cpu")


def small_setup(name, seed=0):
    """Narrow reference params (numpy) + small data for one paper task."""
    task = jax_task(name)
    key = jax.random.PRNGKey(seed)
    if name == "cifar100":
        params = jsmall.cnn_init(key, (32, 32, 3), 100, channels=(4, 8),
                                 hidden=16)
    elif name == "femnist":
        params = jsmall.dnn_init(key, 784, 62, hidden=16)
    elif name == "shakespeare":
        params = jsmall.gru_init(key, 79, 79, hidden=16)
    else:
        params = jsmall.init_task_model(key, task)
    rng = np.random.default_rng(seed)
    if name == "shakespeare":
        data = jsynthetic.make_shakespeare(rng, num_clients=8,
                                           samples_per_client=10, seq_len=12)
    else:
        data = make_paper_task(name, rng, num_clients=8,
                               samples_per_client=10)
    return task, _np(params), data


def flat(tree, prefix=""):
    """{path: numpy array} of a nested dict of jax arrays or tensors, so two
    trees compare by key whatever their dict order."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def assert_trees_close(got, want, **tol):
    fg, fw = flat(got), flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        np.testing.assert_allclose(fg[k], fw[k], err_msg=k, **tol)


def trees_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# ---------------------------------------------------------------------------
# LM federated training: a spec of examples/specs/ built by the reference
# (``repro.api.experiment.build``) and by hand on the port, same data and
# initial parameters
# ---------------------------------------------------------------------------

SPECS = Path(__file__).resolve().parents[1] / "examples" / "specs"


def record_ids(trainer):
    """Record the client ids of every round the trainer's sampler draws."""
    ids, sample = [], trainer.sampler.round

    def round_(*a, **kw):
        out = sample(*a, **kw)
        ids.append(np.asarray(out[0]).tolist())
        return out

    trainer.sampler.round = round_
    return ids


def lm_spec(name, *overrides):
    from repro.api.spec import ExperimentSpec
    spec = ExperimentSpec.load(str(SPECS / f"{name}.json"))
    return spec.with_overrides(*overrides) if overrides else spec


def lm_trainers(spec, backend=None):
    """(reference trainer, port trainer on the CPU, initial params as
    numpy, reference ids, port ids) for an LM ``spec``; ``backend``: the
    port trainer's (default ``LocalBackend``). The port's trainer
    is built as ``repro/api/experiment.py:83-97`` builds the reference's:
    ``registry.loss_fn(cfg, moe_path=...)`` on ``{"tokens": b["x"]}`` over
    ``make_lm_clients`` data, with the reference's FedConfig and runtime
    constants."""
    from repro.api.experiment import build
    from repro_torch.configs import FedConfig, get_arch
    from repro_torch.configs.base import RuntimeModelConfig
    from repro_torch.core import FedAvgTrainer, RuntimeModel
    from repro_torch.data import PopulationView, make_lm_clients
    from repro_torch.models import registry
    jtr = build(spec).trainer
    init = _np(jtr.params)
    cfg = get_arch(spec.model.arch + ("-reduced" if spec.model.reduced
                                      else ""))
    data = make_lm_clients(np.random.default_rng(spec.data.seed),
                           num_clients=spec.data.clients,
                           vocab=cfg.vocab_size, seq_len=spec.data.seq_len,
                           samples_per_client=spec.data.samples_per_client)
    if spec.sampler.name == "population" and spec.sampler.population:
        data = PopulationView(data, spec.sampler.population)
    model_loss = registry.loss_fn(cfg, moe_path=spec.model.moe_path)
    r = spec.runtime
    fed = FedConfig(**dataclasses.asdict(jtr.fed))
    rt = RuntimeModel(
        registry.param_count(cfg) * r.bytes_per_param * 8 / 1e6,
        RuntimeModelConfig(download_mbps=r.download_mbps,
                           upload_mbps=r.upload_mbps,
                           beta_seconds=r.beta_seconds,
                           bytes_per_param=r.bytes_per_param),
        fed.clients_per_round, heterogeneity=r.heterogeneity)
    tr = FedAvgTrainer(lambda p, b: model_loss(p, {"tokens": b["x"]}),
                       _torch(init), data, fed, rt, device="cpu",
                       backend=backend)
    return jtr, tr, init, record_ids(jtr), record_ids(tr)


def assert_counters_equal(h, jh, ids, jids, rounds):
    """The History counters and the client ids, exactly."""
    assert ids == jids and len(ids) == rounds
    assert h.rounds == jh.rounds == list(range(1, rounds + 1))
    assert h.k == jh.k and h.eta == jh.eta
    assert h.sgd_steps == jh.sgd_steps
    assert h.wall_clock_s == jh.wall_clock_s
    assert h.uplink_mbit == jh.uplink_mbit
    assert h.downlink_mbit == jh.downlink_mbit


def drift_in_steps(got, want, init, atol=TOL["atol"]):
    """Worst element and worst leaf mean of ``|got - want|`` beyond
    ``atol``, in int8 quantisation steps (the leaf's movement over the run
    / 127)."""
    fg, fw, f0 = flat(got), flat(want), flat(init)
    assert sorted(fg) == sorted(fw)
    worst, mean = 0.0, 0.0
    for k in fw:
        step = float(np.max(np.abs(fw[k] - f0[k]))) / 127.0
        diff = np.abs(fg[k] - fw[k])
        worst = max(worst, max(diff.max() - atol, 0.0) / step)
        mean = max(mean, max(diff.mean() - atol / 10, 0.0) / step)
    return worst, mean


def to_port_state(tree):
    """A reference state tree (dicts of jax arrays, ``()`` for none) as
    tensors on the CPU."""
    if isinstance(tree, dict):
        return {k: to_port_state(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_port_state(v) for v in tree)
    return torch.tensor(np.asarray(tree))
