"""The port's ``fedavg_reduce``: its plain version and CPU dispatch against the
reference's Pallas kernel (interpret mode) and oracle. The CUDA kernel
against its plain version is tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fedavg_reduce as jfr
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fedavg_reduce as tfr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# tests/test_kernels.py:12
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, m, dtype, seed):
    """The same values for both packages: numpy f32, rounded to bf16 by each
    framework (both round to nearest even, so they agree exactly)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m)).astype(np.float32)
    z = rng.normal(size=n)
    w = (np.exp(z) / np.exp(z).sum()).astype(np.float32)
    jx = jnp.asarray(x).astype(JNP[dtype])
    tx = torch.tensor(x).to(TORCH[dtype])
    np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                  tx.float().numpy())
    return jx, jnp.asarray(w), tx, torch.tensor(w)


@pytest.mark.parametrize("n,m", [(4, 512), (16, 4096), (7, 1000), (50, 8193)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_reduce_matches_reference(n, m, dtype):
    jx, jw, tx, tw = _inputs(n, m, dtype, seed=n * m)
    want_kernel = np.asarray(jfr.fedavg_reduce(jx, jw, interpret=True),
                             np.float32)
    want_oracle = np.asarray(jref.fedavg_reduce_ref(jx, jw), np.float32)
    before = tfr.launches
    got = tfr.fedavg_reduce(tx, tw)              # CPU dispatch
    plain = tref.fedavg_reduce_ref(tx, tw)
    assert tfr.launches == before                # the plain version ran
    assert got.dtype == TORCH[dtype] and got.shape == (m,)
    assert torch.equal(got, plain)
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_fedavg_reduce_convex_combination():
    x = torch.stack([torch.zeros(300), torch.ones(300)])
    w = torch.tensor([0.25, 0.75])
    np.testing.assert_allclose(tops.fedavg_reduce(x, w).numpy(), 0.75,
                               rtol=1e-6)
    jx = jnp.stack([jnp.zeros(300), jnp.ones(300)])
    np.testing.assert_array_equal(
        tops.fedavg_reduce(x, w).numpy(),
        np.asarray(jfr.fedavg_reduce(jx, jnp.array([0.25, 0.75]),
                                     interpret=True)))


def test_fedavg_reduce_tree_on_cnn_shaped_tree():
    n = 5
    shapes = {"conv1": {"kernel": (3, 3, 3, 4), "bias": (4,)},
              "conv2": {"kernel": (3, 3, 4, 8), "bias": (8,)},
              "fc": {"kernel": (128, 16), "bias": (16,)},
              "out": {"kernel": (16, 10), "bias": (10,)}}
    rng = np.random.default_rng(3)
    stack = {k: {kk: rng.normal(size=(n,) + s).astype(np.float32)
                 for kk, s in v.items()} for k, v in shapes.items()}
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    want = jops.fedavg_reduce_tree(jax.tree.map(jnp.asarray, stack),
                                   jnp.asarray(w))
    got = tops.fedavg_reduce_tree(
        {k: {kk: torch.tensor(a) for kk, a in v.items()}
         for k, v in stack.items()}, torch.tensor(w))
    for k, v in shapes.items():
        for kk, s in v.items():
            assert tuple(got[k][kk].shape) == s
            np.testing.assert_allclose(got[k][kk].numpy(),
                                       np.asarray(want[k][kk]),
                                       **TOL["float32"])


@pytest.mark.parametrize("x,w,err", [
    (torch.zeros(4), torch.ones(4), ValueError),               # rank
    (torch.zeros(3, 8), torch.ones(4), ValueError),            # weights
    (torch.zeros(3, 8, dtype=torch.int32), torch.ones(3), TypeError),
    (torch.zeros(3, 8, dtype=torch.float64), torch.ones(3), TypeError),
    (torch.zeros(3, 8), torch.ones(3, dtype=torch.int64), TypeError),
    (torch.zeros(8, 3).t(), torch.ones(3), ValueError),        # strided
    (torch.zeros(3, 8, device="meta"), torch.ones(3, device="meta"),
     ValueError),                                              # device
])
def test_fedavg_reduce_rejects_what_the_kernel_does_not_take(x, w, err):
    with pytest.raises(err):
        tfr.fedavg_reduce(x, w)
