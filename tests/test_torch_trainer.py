"""The port's ``FedAvgTrainer`` against the reference's trainer on the same
data and initial parameters (History counters exact, losses allclose), and
bitwise against the port's own per-round oracle ``run_reference_rounds``,
mirroring tests/test_engine.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FedConfig as JFed
from repro.core import FedAvgTrainer as JTrainer
from repro.core import RuntimeModel as JRuntime
from repro.models import small as jsmall
from repro_torch.configs import FedConfig, get_paper_task
from repro_torch.core import (DecayController, FedAvgTrainer,
                              RoundScheduler, RuntimeModel, make_eval_fn,
                              run_reference_rounds)
from repro_torch.data import pipeline
from repro_torch.models import small
from test_torch_parity_helpers import (TOL, _torch, assert_trees_close,
                                       small_setup, trees_equal)


# ---------------------------------------------------------------------------
# trainer: against the reference's trainer, and bitwise against the port's
# own per-round oracle
# ---------------------------------------------------------------------------

def _port_trainer(name, params, data, fed):
    task = get_paper_task(name)
    return FedAvgTrainer(lambda p, b: small.task_loss(p, task, b),
                         _torch(params), data, fed,
                         RuntimeModel(task.model_size_mb, task.runtime,
                                      fed.clients_per_round), device="cpu")


@pytest.mark.parametrize("k_schedule", ["fixed", "rounds"])
@pytest.mark.parametrize("name", ["femnist", "cifar100"])
def test_trainer_matches_reference_trainer(name, k_schedule):
    task, params, data = small_setup(name)
    kw = dict(total_clients=8, clients_per_round=4, rounds=4, k0=4,
              eta0=task.fed.eta0, batch_size=4, k_schedule=k_schedule,
              aggregator="kernel", seed=0)
    jtr = JTrainer(lambda p, b: jsmall.task_loss(p, task, b),
                   jax.tree.map(jnp.asarray, params), data, JFed(**kw),
                   JRuntime(task.model_size_mb, task.runtime, 4))
    jh = jtr.run(4)
    tr = _port_trainer(name, params, data, FedConfig(**kw))
    h = tr.run(4)
    assert h.rounds == jh.rounds == [1, 2, 3, 4]
    assert h.k == jh.k
    assert h.eta == jh.eta
    assert h.sgd_steps == jh.sgd_steps
    assert h.wall_clock_s == jh.wall_clock_s
    assert h.uplink_mbit == jh.uplink_mbit
    np.testing.assert_allclose(h.train_loss, jh.train_loss, rtol=1e-4)
    assert_trees_close(tr.params, jtr.params, **TOL)


@pytest.mark.parametrize("kw", [
    dict(k_schedule="fixed", rounds=7, bucket_rounds=3),    # padded tail
    dict(k_schedule="fixed", rounds=5, prefetch=False),
    dict(k_schedule="rounds", rounds=6),
    dict(k_schedule="fixed", rounds=5, server_optimizer="fedadam",
         server_lr=0.01),
    dict(k_schedule="error", rounds=5, loss_window=2),      # feedback mode
    dict(k_schedule="fixed", rounds=4, aggregator="median"),
])
def test_trainer_bitwise_equals_per_round_oracle(kw):
    task, params, data = small_setup("femnist", seed=1)
    fed = FedConfig(total_clients=8, clients_per_round=4, k0=4, eta0=0.3,
                    batch_size=4, seed=2, **{"aggregator": "kernel", **kw})
    rounds = kw["rounds"]
    ref = run_reference_rounds(
        lambda p, b: small.task_loss(p, get_paper_task("femnist"), b),
        _torch(params), data, fed, rounds, device="cpu")
    tr = _port_trainer("femnist", params, data, fed)
    h = tr.run(rounds)
    assert trees_equal(ref.params, tr.params)
    assert list(ref.losses) == h.train_loss
    assert ref.ks == h.k
    # one dispatch a bucket of the scheduler's plan
    plan = RoundScheduler(DecayController(fed), fed,
                          total_rounds=rounds).plan()
    assert tr.dispatch_count == sum(1 for _ in plan)


def test_trainer_eval_weights_ragged_tail_batch():
    task, params, data = small_setup("femnist")
    loss_fn = lambda p, b: small.task_loss(p, get_paper_task("femnist"), b)
    tparams = _torch(params)
    full = make_eval_fn(loss_fn, data, batch_size=len(data.val_y),
                        device="cpu")(tparams)
    ragged = make_eval_fn(loss_fn, data, batch_size=100,
                          device="cpu")(tparams)     # 512 = 5 x 100 + 12
    np.testing.assert_allclose(ragged["acc"], full["acc"], atol=1e-6)
    np.testing.assert_allclose(ragged["loss"], full["loss"], rtol=1e-5)
    tr = FedAvgTrainer(loss_fn, tparams, data,
                       FedConfig(clients_per_round=4, k0=2, batch_size=4),
                       RuntimeModel(1.0, task.runtime, 4),
                       make_eval_fn(loss_fn, data, device="cpu"),
                       device="cpu")
    h = tr.run(4, eval_every=2)
    assert h.val_rounds == [2, 4]
    assert all(0.0 <= e <= 1.0 for e in h.val_error)


def test_run_bucket_runs_one_round_like_round_fn():
    """``RoundEngine.run_bucket`` on two successive one-round buckets
    equals the single-round ``make_round_fn`` bitwise, one dispatch per
    call."""
    from repro_torch.core import make_round_fn
    from repro_torch.core.engine.round import RoundEngine
    task, params, data = small_setup("femnist")
    loss_fn = lambda p, b: small.task_loss(p, get_paper_task("femnist"), b)
    bb = pipeline.bucket_batches(np.random.default_rng(0), data, n_rounds=2,
                                 k=2, clients_per_round=3, batch_size=4)
    eng = RoundEngine(loss_fn, aggregator="kernel", device="cpu")
    round_fn, _ = make_round_fn(loss_fn, aggregator="kernel", device="cpu")
    p = q = _torch(params)
    for i in range(2):
        batches = {k: v[i:i + 1] for k, v in bb.batches.items()}
        p, firsts, lasts, _ = eng.run_bucket(
            p, batches, bb.weights[i:i + 1], np.full(1, 0.3, np.float32),
            np.ones(1, bool), ())
        q, want_firsts, want_mean_last, _ = round_fn(
            q, {k: v[0] for k, v in batches.items()}, bb.weights[i], 0.3,
            ())
        assert tuple(firsts.shape) == (1, 3) and eng.dispatch_count == i + 1
        assert torch.equal(firsts[0], want_firsts)
        assert torch.equal(torch.mean(lasts[0]), want_mean_last)
        assert trees_equal(p, q)
