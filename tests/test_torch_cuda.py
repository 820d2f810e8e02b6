"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every test skips without a CUDA card (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import delta_codec as tdc
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


# ---------------------------------------------------------------------------
# the wire path's kernels (csrc/delta_codec.cu)
# ---------------------------------------------------------------------------


def _close_to_max(got, want, rtol=1e-5):
    """Sums in another order: within ``rtol`` of the largest |want|."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=rtol * scale)


def _planes(rng, n, m, cuda):
    q = torch.tensor(rng.integers(-127, 128, size=(n, m)), dtype=torch.int8)
    qr = torch.tensor(rng.integers(-127, 128, size=(n, m)), dtype=torch.int8)
    w = torch.tensor(rng.random(n) * 1e-3, dtype=torch.float32)
    wr = torch.tensor(rng.random(n) * 1e-5, dtype=torch.float32)
    return q.to(cuda), qr.to(cuda), w.to(cuda), wr.to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(25, 2097152), (60, 156800), (25, 100),
                                 (7, 1000), (3, 1), (1, 16)])
@pytest.mark.parametrize("planes", [1, 2])
def test_int8_decompress_reduce_kernel_matches_plain_version(cuda, n, m,
                                                             planes):
    q, qr, w, wr = _planes(np.random.default_rng(n + m), n, m, cuda)
    two = planes == 2
    args = (q, w, qr if two else None, wr if two else None)
    before = tdc.launches["int8_decompress_reduce"]
    got = tdc.int8_decompress_reduce(*args)
    again = tdc.int8_decompress_reduce(*args)
    torch.cuda.synchronize()
    assert tdc.launches["int8_decompress_reduce"] == before + 2
    assert got.dtype == torch.float32 and got.shape == (m,)
    assert torch.equal(got, again)               # no atomics: repeatable
    _close_to_max(got, tref.int8_decompress_reduce_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2097152, 156800, 200, 8193, 1])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_decode_apply_kernel_matches_plain_version(cuda, m, planes,
                                                        dtype):
    rng = np.random.default_rng(m)
    q, qr, _, _ = _planes(rng, 1, m, cuda)
    ref = torch.tensor(rng.normal(size=m), dtype=torch.float32).to(cuda, dtype)
    s = torch.tensor([3e-3], device=cuda)
    rs = torch.tensor([2e-5], device=cuda)
    two = planes == 2
    args = (ref, q[0], s, qr[0] if two else None, rs if two else None)
    before = tdc.launches["int8_decode_apply"]
    got = tdc.int8_decode_apply(*args)
    torch.cuda.synchronize()
    assert tdc.launches["int8_decode_apply"] == before + 1
    assert got.dtype == dtype and got.shape == (m,)
    # the kernel rounds each product and sum as the plain version does
    torch.testing.assert_close(got, tref.int8_decode_apply_ref(*args),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_int8_decode_apply_kernel_on_offset_view_takes_scalar_path(cuda):
    base = torch.randn(4097, device=cuda)
    ref = base[1:]
    q = torch.randint(-127, 128, (4096,), dtype=torch.int8, device=cuda)
    s = torch.tensor([1e-2], device=cuda)
    torch.testing.assert_close(tdc.int8_decode_apply(ref, q, s),
                               tref.int8_decode_apply_ref(ref, q, s),
                               rtol=0, atol=0)


def _distinct_payload(rng, n, k, m, cuda):
    """(N, S) payload whose rows hold distinct indices, as top-k's do."""
    idx = np.stack([rng.permutation(m)[:k] for _ in range(n)])
    vals = rng.normal(size=(n, k))
    z = rng.normal(size=n)
    w = np.exp(z) / np.exp(z).sum()
    return (torch.tensor(vals, dtype=torch.float32, device=cuda),
            torch.tensor(idx, dtype=torch.int32, device=cuda),
            torch.tensor(w, dtype=torch.float32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(25, 209716, 2097152), (60, 15680, 156800),
                                   (25, 4, 32), (3, 5, 17), (1, 1, 1)])
def test_topk_scatter_reduce_kernel_matches_plain_version(cuda, n, k, m):
    vals, idx, w = _distinct_payload(np.random.default_rng(n * k), n, k, m,
                                     cuda)
    before = tdc.launches["topk_scatter_reduce"]
    got = tdc.topk_scatter_reduce(vals, idx, w, m)
    again = tdc.topk_scatter_reduce(vals, idx, w, m)
    torch.cuda.synchronize()
    assert tdc.launches["topk_scatter_reduce"] == before + 2 * n   # per row
    # distinct indices in a row: every output summed in client order, in
    # the kernel and in the row-by-row plain version alike
    assert torch.equal(got, again)
    assert torch.equal(got, tref.topk_scatter_reduce_ref(vals, idx, w, m))


@pytest.mark.cuda
def test_topk_scatter_reduce_kernel_edge_cases(cuda):
    vals = torch.tensor([[1.0, 2.0, 4.0], [8.0, 16.0, 32.0]], device=cuda)
    w = torch.tensor([1.0, 0.5], device=cuda)
    dup = torch.tensor([[0, 0, 3], [3, 1, 0]], dtype=torch.int32, device=cuda)
    pad = torch.tensor([[0, -1, 3], [-1, 1, 5]], dtype=torch.int32,
                       device=cuda)
    assert tdc.topk_scatter_reduce(vals, dup, w, 5).tolist() == \
        [1 + 2 + 16, 8, 0, 4 + 4, 0]
    assert tdc.topk_scatter_reduce(vals, pad, w, 5).tolist() == \
        [1, 8, 0, 4, 0]
    before = dict(tdc.launches)
    empty = tdc.topk_scatter_reduce(torch.zeros((2, 0), device=cuda),
                                    torch.zeros((2, 0), dtype=torch.int32,
                                                device=cuda), w, 37)
    assert tdc.launches == before and not empty.any() and empty.shape == (37,)


@pytest.mark.cuda
@pytest.mark.parametrize("s,m", [(209716, 2097152), (20, 200), (1, 1),
                                 (130, 4099)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_scatter_apply_kernel_matches_plain_version(cuda, s, m, dtype):
    vals, idx, _ = _distinct_payload(np.random.default_rng(s), 1, s, m, cuda)
    ref = torch.randn(m, device=cuda).to(dtype)
    before = tdc.launches["topk_scatter_apply"]
    got = tdc.topk_scatter_apply(ref, vals[0], idx[0])
    torch.cuda.synchronize()
    assert tdc.launches["topk_scatter_apply"] == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, tref.topk_scatter_apply_ref(ref, vals[0], idx[0]))


@pytest.mark.cuda
def test_topk_scatter_apply_kernel_edge_cases(cuda):
    ref = torch.tensor([10.0, 20.0, 30.0], device=cuda)
    vals = torch.tensor([1.0, 2.0, 4.0], device=cuda)
    for idx, want in (([2, 2, 0], [14.0, 20.0, 33.0]),
                      ([2, -1, 7], [10.0, 20.0, 31.0])):
        got = tdc.topk_scatter_apply(
            ref, vals, torch.tensor(idx, dtype=torch.int32, device=cuda))
        assert got.tolist() == want
    empty = tdc.topk_scatter_apply(ref, vals[:0],
                                   torch.zeros(0, dtype=torch.int32,
                                               device=cuda))
    assert torch.equal(empty, ref)


@pytest.mark.cuda
def test_delta_codec_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((2, 8), dtype=torch.int8, device=cuda)
    w = torch.ones(2, device=cuda)
    with pytest.raises(ValueError):                 # mixed devices
        tdc.int8_decompress_reduce(q, w.cpu())
    with pytest.raises(ValueError):                 # not contiguous
        tdc.int8_decompress_reduce(q[:, ::2], w)
    with pytest.raises(TypeError):                  # f64 weights
        tdc.int8_decompress_reduce(q, w.double())
    with pytest.raises(TypeError):
        tdc.int8_decode_apply(torch.zeros(8, dtype=torch.float16,
                                          device=cuda), q[0], w[:1])
    with pytest.raises(TypeError):                  # int64 indices
        tdc.topk_scatter_apply(torch.zeros(8, device=cuda),
                               torch.zeros(2, device=cuda),
                               torch.zeros(2, dtype=torch.int64,
                                           device=cuda))
