"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every test skips without a CUDA card (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fedavg_reduce as tfr
from repro_torch.kernels import ref as tref

# f32 as tests/test_kernels.py:12; bf16 at one bf16 ulp of the f32 sum
# rounded to bf16 (what the plain version returns): a sum in another order
# may round to the neighbour
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(4, 512), (16, 4096), (7, 1000), (50, 8193),
                                 (25, 100), (60, 62), (1, 4096),
                                 (25, 2097152)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fedavg_reduce_kernel_matches_plain_version(cuda, n, m, dtype):
    rng = np.random.default_rng(n + m)
    x = torch.tensor(rng.normal(size=(n, m)).astype(np.float32)).to(cuda, dtype)
    w = torch.softmax(torch.tensor(rng.normal(size=n)), 0).float().to(cuda)
    before = tfr.launches
    got = tfr.fedavg_reduce(x, w)
    again = tfr.fedavg_reduce(x, w)
    torch.cuda.synchronize()
    assert tfr.launches == before + 2
    assert got.dtype == dtype and got.shape == (m,)
    assert torch.equal(got, again)               # no atomics: repeatable
    want = tref.fedavg_reduce_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_fedavg_reduce_kernel_on_offset_view_takes_scalar_path(cuda):
    """A view 4 bytes off 16-byte alignment must still be exact."""
    base = torch.randn(3 * 1024 + 1, device=cuda)
    x = base[1:].view(3, 1024)
    w = torch.tensor([0.2, 0.3, 0.5], device=cuda)
    torch.testing.assert_close(tfr.fedavg_reduce(x, w),
                               tref.fedavg_reduce_ref(x, w), **TOL[torch.float32])
