"""The four paper models: the port's ``task_loss`` and its gradients against
``repro.models.small.task_loss`` and ``jax.grad``, on the reference's own
initial parameters carried across by ``bridge.params_from_jax``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_paper_task as jax_task
from repro.models import small as jsmall
from repro_torch import bridge
from repro_torch.configs import get_paper_task
from repro_torch.models import small
from test_torch_parity_helpers import assert_trees_close, flat


# float32 on both sides, summed in different orders: the largest deviation
# measured over the four tasks' losses and gradients on the CPU is 4.8e-7,
# well inside 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(task, rng, b=4, seq=16):
    if task.model == "gru":
        x = rng.integers(0, task.num_classes, size=(b, seq)).astype(np.int32)
        y = rng.integers(0, task.num_classes, size=(b, seq)).astype(np.int32)
    else:
        x = rng.normal(size=(b,) + task.input_shape).astype(np.float32)
        y = rng.integers(0, task.num_classes, size=b).astype(np.int32)
    return {"x": x, "y": y}


@pytest.mark.parametrize("name", ["sent140", "femnist", "cifar100",
                                  "shakespeare"])
def test_task_loss_and_grads_match_reference(name):
    jt, tt = jax_task(name), get_paper_task(name)
    jparams = jsmall.init_task_model(jax.random.PRNGKey(0), jt)
    batch = _batch(tt, np.random.default_rng(0))

    jloss_fn = lambda p: jsmall.task_loss(p, jt, batch)
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jparams)

    params = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    tgrads, (tloss, taux) = torch.func.grad_and_value(
        lambda p: small.task_loss(p, tt, tbatch), has_aux=True)(params)

    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert float(taux["acc"]) == float(jaux["acc"])
    assert_trees_close(tgrads, jgrads, **TOL)


@pytest.mark.parametrize("name", ["sent140", "femnist", "cifar100",
                                  "shakespeare"])
def test_init_has_reference_keys_shapes_and_scale(name):
    jparams = jsmall.init_task_model(jax.random.PRNGKey(0), jax_task(name))
    params = small.init_task_model(0, get_paper_task(name), device="cpu")
    fj, ft = flat(jparams), flat(params)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        assert ft[k].shape == fj[k].shape, k
        assert ft[k].dtype == np.float32
        # same initialiser family: zeros stay zeros, the spread matches
        sj, st = float(np.std(fj[k])), float(np.std(ft[k]))
        assert (sj == 0) == (st == 0), k
        if sj:
            assert abs(st / sj - 1) < 0.25, (k, st, sj)
    if name == "cifar100":
        assert sum(p.size for p in ft.values()) == 2168356


def test_params_round_trip_through_bridge():
    jparams = jsmall.init_task_model(jax.random.PRNGKey(1),
                                     jax_task("shakespeare"))
    arrays = jax.tree.map(np.asarray, jparams)
    back = bridge.params_to_numpy(bridge.params_from_jax(arrays, "cpu"))
    fa, fb = flat(arrays), flat(back)
    assert list(fa) == list(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
