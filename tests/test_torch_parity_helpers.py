"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same narrow models and small data for both packages, and tree comparison
by key path."""
import jax
import numpy as np
import torch

from repro.configs import get_paper_task as jax_task
from repro.data import synthetic as jsynthetic
from repro.models import small as jsmall
from repro_torch import bridge
from repro_torch.data import make_paper_task
from repro_torch.optim import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)


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
