"""Held EXACTLY against the reference: synthetic data, batch building, the
K_r / eta_r schedules, the bucket plan and the Eq. 3-5 runtime accounting.
None of this is float math the two frameworks could round differently: it
is numpy and Python on both sides, drawn from the same seeds."""
import dataclasses

import numpy as np
import pytest

from repro.configs import FedConfig as JFed
from repro.configs import get_paper_task as jax_task
from repro.core.engine.scheduler import RoundScheduler as JScheduler
from repro.core.runtime_model import RuntimeModel as JRuntime
from repro.core.schedules import DecayController as JCtrl
from repro.core.schedules import quantize_k as jquantize_k
from repro.data import make_paper_task as jmake
from repro.data import pipeline as jpipe
from repro_torch.configs import FedConfig, get_paper_task
from repro_torch.core.engine.scheduler import RoundScheduler
from repro_torch.core.runtime_model import RuntimeModel
from repro_torch.core.schedules import DecayController, quantize_k
from repro_torch.data import make_paper_task
from repro_torch.data import pipeline

TASKS = ["sent140", "femnist", "cifar100", "shakespeare"]


def _data_equal(a, b):
    assert a.num_classes == b.num_classes
    assert len(a.client_x) == len(b.client_x)
    for xa, xb, ya, yb in zip(a.client_x, b.client_x, a.client_y,
                              b.client_y):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(a.val_x, b.val_x)
    np.testing.assert_array_equal(a.val_y, b.val_y)


@pytest.mark.parametrize("name", TASKS)
def test_synthetic_data_identical(name):
    kw = dict(num_clients=5, samples_per_client=6)
    _data_equal(make_paper_task(name, np.random.default_rng(7), **kw),
                jmake(name, np.random.default_rng(7), **kw))


def test_paper_task_configs_identical():
    for name in TASKS:
        a, b = get_paper_task(name), jax_task(name)
        assert (a.name, a.model, a.num_classes, a.input_shape,
                a.model_size_mb, a.val_fraction) == \
               (b.name, b.model, b.num_classes, b.input_shape,
                b.model_size_mb, b.val_fraction)
        assert dataclasses.asdict(a.fed) == dataclasses.asdict(b.fed)
        assert dataclasses.asdict(a.runtime) == dataclasses.asdict(b.runtime)


@pytest.mark.parametrize("n_rounds,pad_to", [(1, 1), (3, 5)])
def test_bucket_batches_identical(n_rounds, pad_to):
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=8, samples_per_client=12)
    kw = dict(n_rounds=n_rounds, k=3, clients_per_round=4, batch_size=5,
              pad_to=pad_to)
    a = pipeline.bucket_batches(np.random.default_rng(4), data, **kw)
    b = jpipe.bucket_batches(np.random.default_rng(4), data, **kw)
    for key in ("x", "y"):
        np.testing.assert_array_equal(a.batches[key], b.batches[key])
    np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(a.active, b.active)


def test_per_round_builds_draw_the_reference_bucket_stream():
    """The port's trainer asks for one round per request; the draws equal
    the reference's multi-round bucket, row for row."""
    data = make_paper_task("cifar100", np.random.default_rng(0),
                           num_clients=8, samples_per_client=10)
    ref = jpipe.bucket_batches(np.random.default_rng(2), data, n_rounds=4,
                               k=2, clients_per_round=3, batch_size=4,
                               pad_to=8)
    for background in (False, True):
        builder = pipeline.make_builder(data, 3, 4, np.random.default_rng(2),
                                        background=background)
        try:
            for _ in range(4):
                builder.submit(1, 2, pad_to=1)
            rows = [builder.get() for _ in range(4)]
        finally:
            builder.close()
        np.testing.assert_array_equal(
            np.concatenate([r.batches["x"] for r in rows]),
            ref.batches["x"][:4])
        np.testing.assert_array_equal(
            np.concatenate([r.weights for r in rows]), ref.weights[:4])


def test_round_batches_and_weights_identical():
    data = make_paper_task("shakespeare", np.random.default_rng(0),
                           num_clients=6, samples_per_client=4)
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    ids_a = pipeline.sample_clients(ra, data, 4)
    ids_b = jpipe.sample_clients(rb, data, 4)
    np.testing.assert_array_equal(ids_a, ids_b)
    a = pipeline.round_batches(ra, data, ids_a, 2, 3)
    b = jpipe.round_batches(rb, data, ids_b, 2, 3)
    np.testing.assert_array_equal(a["x"], b["x"])
    w = pipeline.client_weights(data, ids_a)
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, jpipe.client_weights(data, ids_b))
    for va, vb in zip(pipeline.val_batches(data, 100),
                      jpipe.val_batches(data, 100)):
        np.testing.assert_array_equal(va["x"], vb["x"])


SCHEDULES = [(k, e) for k in ("fixed", "dsgd", "rounds", "error", "step",
                              "cosine")
             for e in ("fixed", "rounds", "error", "step")]


@pytest.mark.parametrize("k_schedule,eta_schedule", SCHEDULES)
@pytest.mark.parametrize("quant", [dict(), dict(k_quantize=True),
                                   dict(k_quantize=True, k_grid0=40)])
def test_k_and_eta_sequences_identical(k_schedule, eta_schedule, quant):
    kw = dict(k0=30, eta0=0.2, rounds=40, k_schedule=k_schedule,
              eta_schedule=eta_schedule, loss_window=3, plateau_patience=2,
              **quant)
    a, b = DecayController(FedConfig(**kw)), JCtrl(JFed(**kw))
    rng = np.random.default_rng(0)
    for r in range(1, 41):
        assert a.k_for_round(r) == b.k_for_round(r)
        assert a.eta_for_round(r) == b.eta_for_round(r)
        loss = float(3.0 * np.exp(-r / 15) + rng.random() * 0.1)
        a.observe_round_losses(loss)
        b.observe_round_losses(loss)
        if r % 4 == 0:
            err = float(0.5 + 0.01 * rng.random())
            a.observe_validation(err)
            b.observe_validation(err)
    assert a.state_dict() == b.state_dict()


def test_quantize_k_identical():
    for k0 in (1, 7, 50, 80):
        for k in range(0, k0 + 3):
            assert quantize_k(k, k0) == jquantize_k(k, k0)


@pytest.mark.parametrize("kw,eval_every", [
    (dict(k0=10, k_schedule="rounds", k_quantize=True, rounds=50), 7),
    (dict(k0=8, k_schedule="fixed", rounds=23, bucket_rounds=8), None),
    (dict(k0=50, k_schedule="rounds", rounds=12), 4),
    (dict(k0=8, k_schedule="error", rounds=10, loss_window=3), 5),
])
def test_bucket_plan_identical(kw, eval_every):
    total = kw["rounds"]
    a = list(RoundScheduler(DecayController(FedConfig(**kw)),
                            FedConfig(**kw), total_rounds=total,
                            eval_every=eval_every).plan())
    b = list(JScheduler(JCtrl(JFed(**kw)), JFed(**kw), total_rounds=total,
                        eval_every=eval_every).plan())
    assert [dataclasses.astuple(x) for x in a] == \
           [dataclasses.astuple(x) for x in b]


@pytest.mark.parametrize("het", [0.0, 0.5])
@pytest.mark.parametrize("name", TASKS)
def test_runtime_model_identical(name, het):
    task = get_paper_task(name)
    n = task.fed.clients_per_round
    kw = dict(clients_per_round=n, heterogeneity=het, seed=3)
    a = RuntimeModel(task.model_size_mb, task.runtime, **kw)
    b = JRuntime(task.model_size_mb, jax_task(name).runtime, **kw)
    for k in (task.fed.k0, 17, 1):
        ca, cb = a.round_cost(k), b.round_cost(k)
        assert (ca.wall_clock_s, ca.sgd_steps, ca.uplink_mbit,
                ca.downlink_mbit) == (cb.wall_clock_s, cb.sgd_steps,
                                      cb.uplink_mbit, cb.downlink_mbit)
        for round_idx in (None, 5):
            np.testing.assert_array_equal(
                a.draw_client_times(round_idx, [0, 4, 9], k),
                b.draw_client_times(round_idx, [0, 4, 9], k))
    ks = [50, 40, 35, 32]
    assert a.total_time(ks) == b.total_time(ks)
    assert a.total_sgd_steps(ks) == b.total_sgd_steps(ks)
    assert a.relative_sgd_steps(ks, 50) == b.relative_sgd_steps(ks, 50)
    assert a.comm_time() == b.comm_time()
