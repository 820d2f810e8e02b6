"""The port's round engine against the reference's: aggregators, server
optimizers and one ``make_round_fn`` round of each paper task on the same
inputs (allclose)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_round_fn as jmake_round_fn
from repro.core.engine import aggregators as jagg
from repro.core.engine import get_server_optimizer as jget_server
from repro.models import small as jsmall
from repro_torch.configs import get_paper_task
from repro_torch.core import make_round_fn
from repro_torch.core.engine import aggregators as tagg
from repro_torch.core.engine import get_server_optimizer
from repro_torch.data import pipeline
from repro_torch.models import small
from test_torch_parity_helpers import (TOL, _torch, assert_trees_close,
                                       small_setup)

# ---------------------------------------------------------------------------
# aggregators and server optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 6])
@pytest.mark.parametrize("name,kw", [
    ("mean", {}), ("kernel", {}), ("median", {}),
    ("trimmed_mean", dict(trim_fraction=0.0)),
    ("trimmed_mean", dict(trim_fraction=0.1)),
    ("trimmed_mean", dict(trim_fraction=0.34)),
    ("trimmed_mean", dict(trim_fraction=0.5)),
])
def test_aggregators_match_reference(n, name, kw):
    rng = np.random.default_rng(n)
    stack = {"a": {"kernel": rng.normal(size=(n, 7, 3)).astype(np.float32),
                   "bias": rng.normal(size=(n, 3)).astype(np.float32)}}
    stack["a"]["kernel"][0] = 1e6                 # one Byzantine client
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    want = jagg.get_aggregator(name, **kw)(jax.tree.map(jnp.asarray, stack),
                                           jnp.asarray(w))
    got = tagg.get_aggregator(name, **kw)(_torch(stack), torch.tensor(w))
    assert_trees_close(got, want, rtol=2e-4, atol=2e-4)


def test_unknown_aggregator_and_server_raise():
    with pytest.raises(ValueError):
        tagg.get_aggregator("bogus")
    with pytest.raises(ValueError):
        get_server_optimizer("bogus")


@pytest.mark.parametrize("server", ["avg", "fedadam", "fedavgm", "fedyogi"])
def test_server_optimizers_match_reference(server):
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    jsrv, tsrv = jget_server(server), get_server_optimizer(server)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jsrv.init(jp), tsrv.init(tp)
    for _ in range(3):
        agg = {k: (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
               for k, v in params.items()}
        jp, js = jsrv.step(jp, jax.tree.map(jnp.asarray, agg), js, 0.5)
        tp, ts = tsrv.step(tp, _torch(agg), ts, 0.5)
    for key in params:
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# one round against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server", ["avg", "fedavgm"])
@pytest.mark.parametrize("name", ["sent140", "femnist", "cifar100",
                                  "shakespeare"])
def test_one_round_matches_reference(name, server):
    task, params, data = small_setup(name)
    rng = np.random.default_rng(5)
    ids = pipeline.sample_clients(rng, data, 3)
    batches = pipeline.round_batches(rng, data, ids, 3, 4)
    weights = pipeline.client_weights(data, ids)
    eta = task.fed.eta0

    jround, jinit = jmake_round_fn(
        lambda p, b: jsmall.task_loss(p, task, b), server=server,
        server_lr=0.5, aggregator="kernel")
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jinit(jp) if jinit is not None else ()
    for _ in range(2):                            # state threads through
        jp, jfirst, jlast, jstate = jround(
            jp, {k: jnp.asarray(v) for k, v in batches.items()},
            jnp.asarray(weights), jnp.float32(eta), jstate)

    tround, tinit = make_round_fn(
        lambda p, b: small.task_loss(p, get_paper_task(name), b),
        server=server, server_lr=0.5, aggregator="kernel", device="cpu")
    tp = _torch(params)
    tstate = tinit(tp) if tinit is not None else ()
    for _ in range(2):
        tp, tfirst, tlast, tstate = tround(tp, batches, weights, eta, tstate)

    np.testing.assert_allclose(tfirst.numpy(), np.asarray(jfirst), **TOL)
    np.testing.assert_allclose(float(tlast), float(jlast), **TOL)
    assert_trees_close(tp, jp, **TOL)
