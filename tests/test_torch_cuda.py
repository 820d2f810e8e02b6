"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Every test skips without a CUDA card (the kernels have no CPU mode)."""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import delta_codec as tdc
from repro_torch.kernels import fedavg_reduce as tfr
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss

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


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(25, 2097152), (7, 8193), (4, 1000),
                                 (1, 4096)])
def test_fedavg_reduce_f32_output_of_a_bf16_stack(cuda, n, m):
    """The f32 partial a rank of the sharded reduce all-reduces: bf16 in,
    f32 out, against the plain version at the f32 tolerance; f32 in with
    out_dtype f32 is the default route bit for bit."""
    rng = np.random.default_rng(n * m)
    x = torch.tensor(rng.normal(size=(n, m)).astype(np.float32)).to(cuda)
    w = torch.softmax(torch.tensor(rng.normal(size=n)), 0).float().to(cuda)
    xb = x.to(torch.bfloat16)
    before = tfr.launches
    got = tfr.fedavg_reduce(xb, w, out_dtype=torch.float32)
    again = tfr.fedavg_reduce(xb, w, out_dtype=torch.float32)
    assert torch.equal(tfr.fedavg_reduce(x, w, out_dtype=torch.float32),
                       tfr.fedavg_reduce(x, w))
    torch.cuda.synchronize()
    assert tfr.launches == before + 4
    assert got.dtype == torch.float32 and torch.equal(got, again)
    torch.testing.assert_close(
        got, tref.fedavg_reduce_ref(xb, w, torch.float32),
        **TOL[torch.float32])
    with pytest.raises(TypeError):
        tfr.fedavg_reduce(x, w, out_dtype=torch.bfloat16)


# the chunk sizes of csrc/fedavg_reduce.cu (8 rows on the 16-byte path, 16
# on one column a thread; ``test_fedavg_reduce_layout`` holds them to the
# library's) on both sides, and the paper tasks' N
ORDER_N = [1, 7, 8, 9, 16, 17, 25, 60]
ORDER_M = [1, 62, 200, 8193, 2097152]
# (input dtype, out_dtype argument): the default route, the sharded
# reduce's f32 partial of a bf16 stack, and bf16 end to end
ORDER_DTYPES = [(torch.float32, None), (torch.bfloat16, torch.float32),
                (torch.bfloat16, None)]


@pytest.mark.cuda
def test_fedavg_reduce_layout(cuda):
    """The library launches the layout the wrapper plans with, and the
    client-order test takes N on both sides of each chunk size."""
    layout = tfr.kernel_layout()
    assert (layout["threads"], layout["max_leaves"]) == (tfr.THREADS,
                                                         tfr.MAX_LEAVES)
    for r in (layout["rows_vec"], layout["rows_scalar"]):
        assert r in ORDER_N and r + 1 in ORDER_N


@pytest.mark.cuda
def test_fedavg_reduce_plans_each_layout_of_its_arguments(cuda):
    """A call with the shapes, dtypes and alignments of an earlier call
    reuses its plan; an offset view of the same shape is planned anew on
    the one-column path, and a stack that is not contiguous still raises."""
    n, m = 3, 4 * tfr.VEC_MIN_GROUPS
    base = torch.randn((n * m + 4,), device=cuda)
    w = torch.softmax(torch.randn((n,), device=cuda), 0)
    aligned, offset = base[:n * m].view(n, m), base[1:n * m + 1].view(n, m)
    for x, vec in ((aligned, True), (offset, False), (aligned, True)):
        got = tfr.fedavg_reduce(x, w)
        assert [r.vec for r in tfr.last_plans[0].leaves] == [vec]
        torch.testing.assert_close(got, tref.fedavg_reduce_ref(x, w),
                                   **TOL[torch.float32])
    with pytest.raises(ValueError):
        tfr.fedavg_reduce(torch.randn((m, n), device=cuda).t(), w)


def _order_inputs(rng, n, m, dtype):
    """Rows mixing +-1e8 and +-1 (as ``dtype`` holds them) and weights that
    are powers of two: every w*x is exact in f32, and another order of the
    clients, or a split of N, rounds the sum differently."""
    vals = np.array([1e8, -1e8, 1.0, -1.0], np.float32)
    x = torch.tensor(vals[rng.integers(0, 4, (n, m), dtype=np.int8)])
    x = x.to(dtype)
    w = (np.float32(2.0) ** -rng.integers(0, 4, n)).astype(np.float32)
    return x, w


def _in_order(x, w):
    """The f32 sum over the clients in order, as numpy runs it."""
    acc = np.zeros(x.shape[1], np.float32)
    for c in range(x.shape[0]):
        acc = acc + np.float32(w[c]) * x[c]
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("m", ORDER_M)
@pytest.mark.parametrize("n", ORDER_N)
@pytest.mark.parametrize("dtype,out_dtype", ORDER_DTYPES)
def test_fedavg_reduce_follows_the_client_order_exactly(cuda, n, m, dtype,
                                                        out_dtype):
    """Both entry points equal the in-order f32 chain bit for bit, on rows
    where the order shows (checked on the host for N >= 7 and M from 62 to
    8193)."""
    rng = np.random.default_rng(1000 * n + m)
    x, w = _order_inputs(rng, n, m, dtype)
    xf = x.float().numpy()
    want = _in_order(xf, w)
    if n >= 7 and 62 <= m <= 8193:
        assert not np.array_equal(want, _in_order(xf[::-1], w[::-1]))
    want = torch.tensor(want).to(out_dtype or dtype)
    xc, wc = x.to(cuda), torch.tensor(w, device=cuda)
    before = tfr.launches
    one = tfr.fedavg_reduce(xc, wc, out_dtype)
    tree = (tops.fedavg_reduce_tree({"leaf": xc}, wc)["leaf"]
            if out_dtype is None else one)
    torch.cuda.synchronize()
    assert tfr.launches == before + (2 if out_dtype is None else 1)
    assert one.dtype == want.dtype and torch.equal(one.cpu(), want)
    assert torch.equal(tree.cpu(), want)


def _tree_case(case, rng, cuda):
    """A client-stacked tree on the card and its weights: a paper task's
    model at its paper N; ``mixed``: the CIFAR100 tree with every other
    leaf in bf16; ``many``: 2 * MAX_LEAVES + 5 leaves; ``offset``: a leaf
    that is a contiguous view 4 bytes off 16-byte alignment."""
    from repro_torch.configs import get_paper_task
    from repro_torch.models import small
    from repro_torch.optim import tree_map
    name = case if case in ("femnist", "sent140", "shakespeare") \
        else "cifar100"
    task = get_paper_task(name)
    n = task.fed.clients_per_round
    params = small.init_task_model(0, task, device="cpu")
    draw = lambda shape: torch.tensor(
        rng.normal(size=shape).astype(np.float32), device=cuda)
    tree = tree_map(lambda p: draw((n,) + tuple(p.shape)), params)
    if case == "mixed":
        for i, sub in enumerate(tree.values()):
            for k in list(sub)[i % 2::2]:
                sub[k] = sub[k].to(torch.bfloat16)
    elif case == "many":
        tree = {f"l{i}": draw((n, 1 + 37 * i))
                for i in range(2 * tfr.MAX_LEAVES + 5)}
        tree["big"] = draw((n, 2 ** 21))
    elif case == "offset":
        m = 2 ** 21
        base = draw((n * m + 1,))
        tree["view"] = {"kernel": base[1:].view(n, 512, m // 512)}
    w = torch.softmax(torch.tensor(rng.normal(size=n)), 0).float().to(cuda)
    return tree, w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cifar100", "femnist", "sent140",
                                  "shakespeare", "mixed", "many", "offset"])
def test_fedavg_reduce_tree_equals_the_per_leaf_calls(cuda, case):
    """One launch for each dtype group of up to MAX_LEAVES leaves, and
    every output bitwise ``fedavg_reduce`` on its leaf."""
    import math
    from repro_torch.optim import tree_leaves
    tree, w = _tree_case(case, np.random.default_rng(len(case)), cuda)
    leaves = tree_leaves(tree)
    n = w.shape[0]
    groups = {}
    for x in leaves:
        groups[x.dtype] = groups.get(x.dtype, 0) + 1
    if case == "offset":
        assert leaves[-1].data_ptr() % 16 == 4
    before = tfr.launches
    got = tree_leaves(tops.fedavg_reduce_tree(tree, w))
    torch.cuda.synchronize()
    assert tfr.launches - before == sum(
        math.ceil(c / tfr.MAX_LEAVES) for c in groups.values())
    assert len(groups) == (2 if case == "mixed" else 1)
    before = tfr.launches
    for x, g in zip(leaves, got):
        one = tfr.fedavg_reduce(x.reshape(n, -1), w).reshape(x.shape[1:])
        assert g.dtype == x.dtype and torch.equal(g, one)
        torch.testing.assert_close(
            g.float(), tref.fedavg_reduce_ref(x.reshape(n, -1), w)
            .reshape(x.shape[1:]).float(), **TOL[x.dtype])
    torch.cuda.synchronize()
    assert tfr.launches - before == len(leaves)


# ---------------------------------------------------------------------------
# the client-sharded wrappers at world 1 over NCCL
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_meshes(tmp_path_factory):
    """A one-rank NCCL group on the card and its meshes: (1,) ("data",)
    and (1, 1) ("pod", "data")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card")
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    path = tmp_path_factory.mktemp("nccl") / "init"
    init_distributed("cuda", init_method=f"file://{path}", rank=0,
                     world_size=1)
    yield {"data": (make_mesh((1,), ("data",), "cuda"), ("data",)),
           "pod_data": (make_mesh((1, 1), ("pod", "data"), "cuda"),
                        ("pod", "data"))}
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_name,grouped", [("data", False),
                                               ("pod_data", False),
                                               ("pod_data", True)])
def test_sharded_wrappers_at_one_rank_equal_unsharded_kernels(
        nccl_meshes, mesh_name, grouped):
    """One rank holds every row, so the sharded wrapper (kernel, then the
    NCCL collective) gives its unsharded kernel's result bit for bit, and
    counts one launch a call."""
    from repro_torch.kernels import collectives
    mesh, axes = nccl_meshes[mesh_name]
    tiers = tuple((a,) for a in reversed(axes)) if grouped else None
    kw = dict(mesh=mesh, client_axes=axes, reduce_tiers=tiers)
    cuda = torch.device("cuda")
    rng = np.random.default_rng(7)
    n, m = 25, 65536
    x = torch.tensor(rng.normal(size=(n, m)).astype(np.float32)).to(cuda)
    w = torch.softmax(torch.tensor(rng.normal(size=n)), 0).float().to(cuda)
    q, qr, we, wr = _planes(rng, n, m, cuda)
    vals = torch.tensor(rng.normal(size=(n, 600)).astype(np.float32)).to(cuda)
    idx = torch.tensor(rng.integers(0, m, (n, 600)),
                       dtype=torch.int32).to(cuda)
    ref_ = torch.tensor(rng.normal(size=m).astype(np.float32)).to(cuda)
    s = torch.tensor([0.01], device=cuda)
    rs = torch.tensor([1e-4], device=cuda)
    before = (tfr.sharded_launches, dict(tdc.sharded_launches),
              dict(collectives.counts))
    pairs = [
        (tfr.fedavg_reduce_sharded(x, w, **kw), tfr.fedavg_reduce(x, w)),
        (tfr.fedavg_reduce_sharded(x.to(torch.bfloat16), w, **kw),
         tfr.fedavg_reduce(x.to(torch.bfloat16), w)),
        (tdc.int8_decompress_reduce_sharded(q, we, **kw),
         tdc.int8_decompress_reduce(q, we)),
        (tdc.int8_decompress_reduce_sharded(q, we, qr, wr, **kw),
         tdc.int8_decompress_reduce(q, we, qr, wr)),
        (tdc.topk_scatter_reduce_sharded(vals, idx, w, m, **kw),
         tdc.topk_scatter_reduce(vals, idx, w, m)),
        (tdc.int8_decode_apply_sharded(ref_, q[0], s, mesh=mesh, axes=axes),
         tdc.int8_decode_apply(ref_, q[0], s)),
        (tdc.int8_decode_apply_sharded(ref_, q[0], s, qr[0], rs, mesh=mesh,
                                       axes=axes),
         tdc.int8_decode_apply(ref_, q[0], s, qr[0], rs)),
    ]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == want.dtype and torch.equal(got, want), i
    tiers_n = len(axes) if grouped else 1
    assert tfr.sharded_launches == before[0] + 2
    assert {k: v - before[1][k] for k, v in tdc.sharded_launches.items()} \
        == {"int8_decompress_reduce_sharded": 2,
            "int8_decode_apply_sharded": 2,
            "topk_scatter_reduce_sharded": 1}
    assert collectives.counts["all_reduce"] == \
        before[2]["all_reduce"] + 5 * tiers_n
    assert collectives.counts["all_gather"] == before[2]["all_gather"] + 2


@pytest.mark.cuda
def test_sharded_wrappers_without_a_row_return_zeros_and_launch_nothing(
        nccl_meshes):
    """A rank that holds no client row (a streamed round's tail slab
    smaller than the world): each sharded reduce returns zeros of the
    leaf's size through its collective and launches no kernel. Then one
    narrow CIFAR100 round on the mesh as one slab of the whole cohort
    launches each sharded kernel once a leaf: ``fedavg_reduce_sharded``
    (the kernel aggregator), ``int8_decompress_reduce_sharded`` and
    ``topk_scatter_reduce_sharded`` (the int8 and top-k uplinks)."""
    from repro_torch.configs import FedConfig, get_paper_task
    from repro_torch.core import FedAvgTrainer, RuntimeModel
    from repro_torch.core.engine.backends import MeshBackend
    from repro_torch.data import make_paper_task
    from repro_torch.kernels import collectives
    from repro_torch.models import small
    from repro_torch.optim import tree_leaves
    mesh, axes = nccl_meshes["data"]
    kw = dict(mesh=mesh, client_axes=axes)
    cuda = torch.device("cuda")
    m, none = 1000, torch.empty((0,), device=cuda)
    counters = lambda: (tfr.launches, tfr.sharded_launches,
                        dict(tdc.launches), dict(tdc.sharded_launches))
    before, reduces = counters(), collectives.counts["all_reduce"]
    outs = [
        tfr.fedavg_reduce_sharded(torch.empty((0, m), device=cuda), none,
                                  **kw),
        tdc.int8_decompress_reduce_sharded(
            torch.empty((0, m), dtype=torch.int8, device=cuda), none, **kw),
        tdc.int8_decompress_reduce_sharded(
            torch.empty((0, m), dtype=torch.int8, device=cuda), none,
            torch.empty((0, m), dtype=torch.int8, device=cuda), none, **kw),
        tdc.topk_scatter_reduce_sharded(
            torch.empty((0, 16), device=cuda),
            torch.empty((0, 16), dtype=torch.int32, device=cuda), none, m,
            **kw),
        tops.fedavg_reduce_tree_sharded(
            {"w": torch.empty((0, 40, 25), device=cuda)}, none,
            **kw)["w"].reshape(-1)]
    torch.cuda.synchronize()
    for out in outs:
        assert out.dtype == torch.float32 and torch.equal(
            out, torch.zeros(m, device=cuda))
    assert counters() == before
    assert collectives.counts["all_reduce"] == reduces + len(outs)
    task = get_paper_task("cifar100")
    data = make_paper_task("cifar100", np.random.default_rng(1),
                           num_clients=8, samples_per_client=16)
    init = small.cnn_init(torch.Generator().manual_seed(1), (32, 32, 3), 100,
                          channels=(8, 16), hidden=32)
    leaves = len(tree_leaves(init))
    for fed_kw, kernel in ((dict(aggregator="kernel"),
                            "fedavg_reduce_sharded"),
                           (dict(transport="int8"),
                            "int8_decompress_reduce_sharded"),
                           (dict(transport="topk"),
                            "topk_scatter_reduce_sharded")):
        fed = FedConfig(total_clients=8, clients_per_round=4, k0=2,
                        batch_size=4, cohort_chunk=4, **fed_kw)
        tr = FedAvgTrainer(lambda p, b: small.task_loss(p, task, b), init,
                           data, fed, RuntimeModel(1.0, task.runtime, 4),
                           backend=MeshBackend(mesh))
        before = {"fedavg_reduce_sharded": tfr.sharded_launches,
                  **tdc.sharded_launches}
        h = tr.run(1)
        torch.cuda.synchronize()
        after = {"fedavg_reduce_sharded": tfr.sharded_launches,
                 **tdc.sharded_launches}
        assert {k: v - before[k] for k, v in after.items()} == {
            k: leaves if k == kernel else 0 for k in after}, kernel
        assert all(math.isfinite(v) for v in h.train_loss)


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


def _in_order_planes(q, w, qr, wr):
    """Each plane's f32 sum over the clients in order, as numpy runs it,
    the two sums added at the end."""
    acc = _in_order(q.float().numpy(), w)
    if qr is None:
        return acc
    return acc + _in_order(qr.float().numpy(), wr)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 511, 512, 513, 8193, 12400, 40000, 156800,
                               2 ** 21])
@pytest.mark.parametrize("n", [3, 25, 60])
@pytest.mark.parametrize("planes", [1, 2])
def test_int8_decompress_reduce_follows_the_client_order_exactly(
        cuda, n, m, planes):
    """Weights that are powers of two from 1 to 2**-29 make every w*q exact
    in f32 and the sums round, so only the order of the adds shows (checked
    on the host for N >= 25, M >= 511): the kernel equals the in-order
    chain of each plane, the two added at the end, bit for bit, on both
    layouts (4 columns a lane from 2**21 on, one column a thread below)
    and on an offset view (one column a thread)."""
    rng = np.random.default_rng(7 * n + m)
    q = torch.tensor(rng.integers(-127, 128, size=(n, m)), dtype=torch.int8)
    qr = torch.tensor(rng.integers(-127, 128, size=(n, m)), dtype=torch.int8)
    w = (np.float32(2.0) ** -rng.integers(0, 30, n)).astype(np.float32)
    wr = (np.float32(2.0) ** -rng.integers(0, 30, n)).astype(np.float32)
    if planes == 1:
        qr, wr = None, None
    want = _in_order_planes(q, w, qr, wr)
    if n >= 25 and m >= 511:
        assert not np.array_equal(
            want, _in_order_planes(q.flip(0), w[::-1],
                                   None if qr is None else qr.flip(0),
                                   None if wr is None else wr[::-1]))
    wc = torch.tensor(w, device=cuda)
    wrc = None if wr is None else torch.tensor(wr, device=cuda)
    before = tdc.launches["int8_decompress_reduce"]
    got = tdc.int8_decompress_reduce(q.to(cuda), wc,
                                     None if qr is None else qr.to(cuda), wrc)
    # the same rows one byte into a buffer: no row is 4-byte aligned
    base = torch.zeros(2 * n * m + 1, dtype=torch.int8, device=cuda)
    qo = base[1:n * m + 1].view(n, m)
    qo.copy_(q)
    qro = None
    if qr is not None:
        qro = base[n * m + 1:].view(n, m)
        qro.copy_(qr)
    offset = tdc.int8_decompress_reduce(qo, wc, qro, wrc)
    torch.cuda.synchronize()
    assert tdc.launches["int8_decompress_reduce"] == before + 2
    assert torch.equal(got.cpu(), torch.tensor(want))
    assert torch.equal(offset.cpu(), torch.tensor(want))


@pytest.mark.cuda
# the paths' leaves, and M around a warp step (512 f32 / 1,024 bf16
# values) and a partial last step on the 16-byte path (16 * 1024 + 16)
@pytest.mark.parametrize("m", [2097152, 156800, 200, 8193, 1, 511, 512, 513,
                               16 * 1024 + 16])
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


@pytest.mark.cuda
@pytest.mark.parametrize("m", [513, 16 * 1024 + 16, 16 * 1024 + 520])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_decode_apply_kernel_writes_nothing_past_m(cuda, m, dtype):
    """The C entry point on views of larger buffers: out[:m] is the plain
    version's, and the sentinel after it is untouched, on the last,
    partial step of the 16-byte path (and the scalar path at 513)."""
    from repro_torch.kernels import _build
    rng = np.random.default_rng(m)
    pad = 4096
    q, qr, _, _ = _planes(rng, 1, m + pad, cuda)
    ref = torch.tensor(rng.normal(size=m + pad), dtype=torch.float32)
    ref = ref.to(cuda, dtype)
    s = torch.tensor([3e-3], device=cuda)
    rs = torch.tensor([2e-5], device=cuda)
    out = torch.full((m + pad,), 7.0, dtype=dtype, device=cuda)
    lib = _build.load("delta_codec")
    for planes in (1, 2):
        two = planes == 2
        err = lib.int8_apply_launch(
            ref.data_ptr(), q.data_ptr(), s.data_ptr(),
            qr.data_ptr() if two else None, rs.data_ptr() if two else None,
            out.data_ptr(), m, tdc._DTYPE_TAGS[dtype],
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        want = tref.int8_decode_apply_ref(ref[:m], q[0, :m], s,
                                          qr[0, :m] if two else None,
                                          rs if two else None)
        assert torch.equal(out[:m], want)
        assert bool((out[m:] == 7.0).all())


def _distinct_payload(rng, n, k, m, cuda):
    """(N, S) payload whose rows hold distinct indices, as top-k's do."""
    idx = np.stack([rng.permutation(m)[:k] for _ in range(n)])
    vals = rng.normal(size=(n, k))
    z = rng.normal(size=n)
    w = np.exp(z) / np.exp(z).sum()
    return (torch.tensor(vals, dtype=torch.float32, device=cuda),
            torch.tensor(idx, dtype=torch.int32, device=cuda),
            torch.tensor(w, dtype=torch.float32, device=cuda))


# rows of up to 2,048 entries run on one block (csrc/delta_codec.cu
# kOneBlockEntries), longer rows on a grid: both sides of the limit
@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(25, 209716, 2097152), (60, 15680, 156800),
                                   (25, 5120, 51200), (25, 1844, 18432),
                                   (25, 2048, 20480), (25, 2049, 20490),
                                   (3, 1200000, 2500000),
                                   (25, 4, 32), (3, 5, 17), (1, 1, 1)])
def test_topk_scatter_reduce_kernel_matches_plain_version(cuda, n, k, m):
    vals, idx, w = _distinct_payload(np.random.default_rng(n * k), n, k, m,
                                     cuda)
    before = tdc.launches["topk_scatter_reduce"]
    got = tdc.topk_scatter_reduce(vals, idx, w, m)
    again = tdc.topk_scatter_reduce(vals, idx, w, m)
    torch.cuda.synchronize()
    assert tdc.launches["topk_scatter_reduce"] == before + 2   # one a call
    # distinct indices in a row: every output summed in client order, in
    # the kernel and in the row-by-row plain version alike
    assert torch.equal(got, again)
    assert torch.equal(got, tref.topk_scatter_reduce_ref(vals, idx, w, m))


def _collide_payload(rng, n, k, m, cuda):
    """(N, S) payload on which the order of the rows shows: every row
    holds the same S indices, each row in its own order, with values of
    +-1e8 and +-1 (weights 1), so a sum that takes the rows out of order
    rounds differently."""
    base = rng.permutation(m)[:k]
    idx = np.stack([rng.permutation(base) for _ in range(n)])
    vals = rng.choice([1e8, -1e8, 1.0, -1.0], size=(n, k))
    return (torch.tensor(vals, dtype=torch.float32, device=cuda),
            torch.tensor(idx, dtype=torch.int32, device=cuda),
            torch.ones(n, dtype=torch.float32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(25, 100000, 1000000), (60, 100000, 1000000),
                                   (25, 2000, 4000), (60, 500, 1000)])
def test_topk_scatter_reduce_kernel_keeps_client_order(cuda, n, k, m):
    """Every output takes N adds of +-1e8 and +-1: only the client order
    gives the plain version's bits, and the kernel repeats them."""
    vals, idx, w = _collide_payload(np.random.default_rng(n + k), n, k, m,
                                    cuda)
    want = tref.topk_scatter_reduce_ref(vals, idx, w, m)
    assert not torch.equal(want, tref.topk_scatter_reduce_ref(
        vals.flip(0), idx.flip(0), w, m))           # the order shows
    for _ in range(3):
        assert torch.equal(tdc.topk_scatter_reduce(vals, idx, w, m), want)


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
@pytest.mark.parametrize("s,m", [(209716, 2097152), (5120, 51200),
                                 (1844, 18432), (87, 864), (52, 512),
                                 (10, 100), (4, 32), (20, 200), (1, 1),
                                 (130, 4099), (1200000, 2500000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_scatter_apply_kernel_matches_plain_version(cuda, s, m, dtype):
    vals, idx, _ = _distinct_payload(np.random.default_rng(s), 1, s, m, cuda)
    ref = torch.randn(m, device=cuda).to(dtype)
    before = tdc.launches["topk_scatter_apply"]
    got = tdc.topk_scatter_apply(ref, vals[0], idx[0])
    again = tdc.topk_scatter_apply(ref, vals[0], idx[0])
    torch.cuda.synchronize()
    assert tdc.launches["topk_scatter_apply"] == before + 2   # one a call
    assert got.dtype == dtype and torch.equal(got, again)
    assert torch.equal(got, tref.topk_scatter_apply_ref(ref, vals[0], idx[0]))


@pytest.mark.cuda
def test_topk_scatter_apply_bf16_duplicate_rounds_once_per_add(cuda):
    """A duplicate index in bf16: each add is rounded to bf16, so the
    result is within one bf16 rounding an add of the plain version's f32
    sum rounded once."""
    ref = torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16, device=cuda)
    vals = torch.tensor([1e-3, 2e-3, 3e-3, 0.5], device=cuda)
    idx = torch.tensor([0, 0, 0, 2], dtype=torch.int32, device=cuda)
    got = tdc.topk_scatter_apply(ref, vals, idx).float()
    want = tref.topk_scatter_apply_ref(ref, vals, idx).float()
    assert got[1:].tolist() == want[1:].tolist()
    assert abs(float(got[0] - want[0])) <= 3 * 2 ** -7


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


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

# tests/test_kernels.py:12: f32 2e-4, bf16 3e-2
FA_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
          torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
FA_CASES = [
    # (B, H, KV, Sq, Sk, hd, causal, window, softcap)
    (2, 16, 16, 512, 512, 64, True, None, None),    # qwen1.5-0.5b heads
    (1, 8, 2, 300, 300, 64, True, None, None),      # GQA, no tile multiple
    (1, 8, 2, 300, 300, 64, True, 64, None),        # window
    (1, 8, 2, 300, 300, 64, True, None, 5.0),       # softcap
    (1, 4, 2, 512, 512, 128, True, 4096, 50.0),     # gemma2 hd 128
    (2, 4, 4, 96, 96, 32, True, None, None),        # reduced configs' hd
    (1, 2, 1, 80, 80, 16, True, 16, None),          # hd 16
    (1, 4, 2, 200, 200, 64, False, None, None),     # non-causal
    (1, 4, 2, 200, 200, 64, False, 48, 20.0),       # non-causal + window
    (2, 4, 2, 1, 257, 64, True, None, None),        # Sq = 1 vs Sk = 257
    (2, 4, 2, 1, 257, 64, False, None, None),
    (2, 32, 32, 4096, 4096, 112, True, None, None),  # zamba2-7b's block
    (1, 96, 8, 2048, 2048, 192, True, None, None),   # nemotron-4-340b, GQA
    (1, 8, 2, 300, 300, 112, True, 64, 5.0),         # hd 112: window, cap
    (1, 4, 2, 200, 200, 192, False, None, None),     # hd 192: non-causal
]


# q and k of stddev 1.6: the scaled scores q.k / sqrt(hd) have stddev ~2.6
# and span several units, so the softmax is far from uniform, the running
# max moves between key tiles (the kernels must rescale O and l) and a
# softcap of 5 bends the largest scores
QK_STD = 1.6
# bf16 outputs row by row against the plain version in f32 on the same
# inputs: rtol x |want| + row_atol x the row's RMS (the wgmma kernel rounds
# P and the output to bf16, 2^-9 relative each)
FA_BF16_ROW_TOL = dict(rtol=2 ** -7, row_atol=2 ** -6)


def _fa_inputs(case, dtype, cuda, seed=0):
    B, H, KV, Sq, Sk, hd = case[:6]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, H, Sq, hd), generator=g) * QK_STD
    k = torch.randn((B, KV, Sk, hd), generator=g) * QK_STD
    v = torch.randn((B, KV, Sk, hd), generator=g)
    return [t.to(cuda, dtype) for t in (q, k, v)]


def _assert_bf16_rows_close(got, q, k, v, **kw):
    """``got`` (bf16) within ``FA_BF16_ROW_TOL`` of the plain version run in
    f32 on the same inputs, every row held to its own scale."""
    want = tref.flash_attention_ref(*(t.float() for t in (q, k, v)), **kw)
    rms = want.square().mean(-1, keepdim=True).sqrt()
    bound = (FA_BF16_ROW_TOL["rtol"] * want.abs()
             + FA_BF16_ROW_TOL["row_atol"] * rms)
    ratio = float(((got.float() - want).abs() / bound).max())
    assert ratio <= 1.0, f"bf16 rows off by {ratio} x the row tolerance"


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(cuda, case, dtype):
    q, k, v = _fa_inputs(case, dtype, cuda)
    causal, window, softcap = case[6:]
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, **kw)
    again = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)               # fixed order: repeatable
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[dtype])
    if dtype == torch.bfloat16:
        _assert_bf16_rows_close(got, q, k, v, **kw)


@pytest.mark.cuda
def test_flash_attention_reads_model_layout_views_and_grads(cuda):
    """ops.flash_attention hands the kernel (B, S, H, hd) tensors as
    transposed views; its gradient goes through the plain version."""
    g = torch.Generator().manual_seed(1)
    B, S, H, KV, hd = 2, 130, 8, 2, 64
    q, k, v = (torch.randn(shape, generator=g).to(cuda).requires_grad_()
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    w = torch.randn((B, S, H, hd), generator=g).to(cuda)
    before = tfa.launches
    out = tops.flash_attention(q, k, v, causal=True, window=40, softcap=30.0)
    assert tfa.launches == before + 1 and out.is_contiguous()
    (out * w).sum().backward()
    refs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = tref.flash_attention_ref(
        *(t.transpose(1, 2) for t in refs), causal=True, window=40,
        softcap=30.0).transpose(1, 2)
    (want * w).sum().backward()
    torch.testing.assert_close(out, want, **FA_TOL[torch.float32])
    for got, ref in zip((q, k, v), refs):
        torch.testing.assert_close(got.grad, ref.grad, **FA_TOL[torch.float32])


# the bf16 path (the tensor-core kernel) at every head dim the kernels take:
# (label, B, H, KV, Sq, Sk, causal, window, softcap)
FA_WGMMA_VARIANTS = [
    ("causal", 1, 4, 2, 200, 200, True, None, None),
    ("noncausal", 1, 4, 4, 200, 200, False, None, None),
    ("window", 1, 4, 2, 300, 300, True, 64, None),
    ("softcap", 1, 4, 2, 300, 300, True, None, 5.0),
    ("gqa_sq_lt_sk", 2, 8, 2, 130, 257, True, None, None),
    ("sq_gt_sk", 1, 4, 2, 257, 130, False, 200, None),
    ("ragged", 2, 2, 1, 1, 77, True, None, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", FA_WGMMA_VARIANTS, ids=lambda v: v[0])
@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_flash_attention_bf16_runs_the_wgmma_kernel(cuda, hd, variant):
    B, H, KV, Sq, Sk, causal, window, softcap = variant[1:]
    case = (B, H, KV, Sq, Sk, hd)
    q, k, v = _fa_inputs(case, torch.bfloat16, cuda, seed=hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    assert tfa.kernel_path(hd, torch.bfloat16) == "wgmma"
    before = dict(tfa.launches_by_path)
    got = tfa.flash_attention(q, k, v, **kw)
    again = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.launches_by_path == {
        p: before[p] + (2 if p == "wgmma" else 0) for p in tfa.PATHS}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again)               # fixed order: repeatable
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(),
                               **FA_TOL[torch.bfloat16])
    _assert_bf16_rows_close(got, q, k, v, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_flash_attention_bf16_reads_model_layout_views(cuda, hd):
    """The wgmma kernel's tensor maps take the (B, S, H, hd) tensors'
    transposed views with their own strides, as ops.flash_attention hands
    them over."""
    g = torch.Generator().manual_seed(hd)
    B, S, H, KV = 2, 130, 8, 2
    q, k, v = ((torch.randn(shape, generator=g) * std).to(cuda,
                                                          torch.bfloat16)
               for shape, std in (((B, S, H, hd), QK_STD),
                                  ((B, S, KV, hd), QK_STD),
                                  ((B, S, KV, hd), 1.0)))
    kw = dict(causal=True, window=40, softcap=5.0)
    before = dict(tfa.launches_by_path)
    out = tops.flash_attention(q, k, v, **kw)
    assert tfa.launches_by_path["wgmma"] == before["wgmma"] + 1
    assert out.is_contiguous() and out.shape == q.shape
    views = [t.transpose(1, 2) for t in (q, k, v)]
    want = tref.flash_attention_ref(*views, **kw).transpose(1, 2)
    torch.testing.assert_close(out.float(), want.float(),
                               **FA_TOL[torch.bfloat16])
    _assert_bf16_rows_close(out.transpose(1, 2), *views, **kw)


def _fully_masked_rows_want(v, sq, window, G):
    """What a row whose window holds no key (non-causal, Sq > Sk + window
    - 1; no model path makes them) comes out as from the kernel, as from
    the Pallas kernel and the port's earlier FMA kernel: the mean of V
    over the keys of the tiles its 64-row group visits (the masked scores
    are all equal there), zero where the group visits none."""
    B, KV, sk, hd = v.shape
    nk = -(-sk // 64)
    out = torch.zeros((B, KV * G, sq, hd), dtype=torch.float32,
                      device=v.device)
    for r in range(sq):
        r0 = r // 64 * 64
        lo = min(max(0, r0 - window + 1) // 64, nk)
        keys = v[:, :, lo * 64:nk * 64].float()
        if keys.shape[2]:
            out[:, :, r] = keys.mean(2).repeat_interleave(G, dim=1)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_flash_attention_f32_fully_masked_rows_average_the_visited_keys(
        cuda, hd):
    """Fully masked rows come out of the f32 path as they did out of the
    FMA kernel it replaces (``_fully_masked_rows_want``); the plain
    version spreads such a row over every key instead (ROADMAP known
    difference)."""
    q, k, v = _fa_inputs((1, 4, 2, 257, 130, hd), torch.float32, cuda)
    kw = dict(causal=False, window=48)
    got = tfa.flash_attention(q, k, v, **kw)
    rows = torch.arange(257, device=cuda) >= 130 + 48 - 1   # fully masked
    want = _fully_masked_rows_want(v, 257, 48, 2)
    torch.testing.assert_close(got[:, :, rows], want[:, :, rows],
                               **FA_TOL[torch.float32])
    ref = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got[:, :, ~rows], ref[:, :, ~rows],
                               **FA_TOL[torch.float32])
    assert not torch.allclose(got[:, :, rows], ref[:, :, rows],
                              **FA_TOL[torch.float32])


@pytest.mark.cuda
def test_flash_attention_bf16_fully_masked_rows_match_the_f32_path(cuda):
    """The bf16 wgmma kernel visits the same key tiles as the f32 path, so
    its fully masked rows are the same averages, within bf16's
    tolerance."""
    q, k, v = _fa_inputs((1, 4, 2, 257, 130, 64), torch.bfloat16, cuda)
    kw = dict(causal=False, window=48)
    got = tfa.flash_attention(q, k, v, **kw)
    f32 = tfa.flash_attention(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got.float(), f32, **FA_TOL[torch.bfloat16])
    rows = torch.arange(257, device=cuda) >= 130 + 48 - 1   # fully masked
    assert bool(rows.any())
    want = tref.flash_attention_ref(q, k, v, **kw)
    assert not torch.allclose(got[:, :, rows].float(),
                              want[:, :, rows].float(),
                              **FA_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", FA_WGMMA_VARIANTS, ids=lambda v: v[0])
@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_flash_attention_f32_runs_the_wgmma_split_kernel(cuda, hd, variant):
    """f32 through the tensor-core kernel on bf16 hi + lo planes (three
    products each): one launch a call on ``"wgmma_split"``, the f32
    tolerance, bitwise repeats."""
    B, H, KV, Sq, Sk, causal, window, softcap = variant[1:]
    q, k, v = _fa_inputs((B, H, KV, Sq, Sk, hd), torch.float32, cuda,
                         seed=hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    assert tfa.kernel_path(hd, torch.float32) == "wgmma_split"
    before = dict(tfa.launches_by_path)
    got = tfa.flash_attention(q, k, v, **kw)
    again = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.launches_by_path == {
        p: before[p] + (2 if p == "wgmma_split" else 0) for p in tfa.PATHS}
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, again)               # fixed order: repeatable
    rows = torch.ones(Sq, dtype=torch.bool, device=cuda)
    if window is not None and not causal:        # no fully masked rows
        rows = torch.arange(Sq, device=cuda) < Sk + window - 1
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got[:, :, rows], want[:, :, rows],
                               **FA_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_flash_attention_f32_reads_model_layout_views(cuda, hd):
    """The f32 path's split pass reads the (B, S, H, hd) tensors'
    transposed views through their strides, as ops.flash_attention hands
    them over, and writes O through the output's strides."""
    g = torch.Generator().manual_seed(hd)
    B, S, H, KV = 2, 130, 8, 2
    q, k, v = ((torch.randn(shape, generator=g) * std).to(cuda)
               for shape, std in (((B, S, H, hd), QK_STD),
                                  ((B, S, KV, hd), QK_STD),
                                  ((B, S, KV, hd), 1.0)))
    kw = dict(causal=True, window=40, softcap=5.0)
    before = dict(tfa.launches_by_path)
    out = tops.flash_attention(q, k, v, **kw)
    assert tfa.launches_by_path["wgmma_split"] == before["wgmma_split"] + 1
    assert out.is_contiguous() and out.shape == q.shape
    views = [t.transpose(1, 2) for t in (q, k, v)]
    want = tref.flash_attention_ref(*views, **kw).transpose(1, 2)
    torch.testing.assert_close(out, want, **FA_TOL[torch.float32])


@pytest.mark.cuda
def test_flash_attention_split_entry_refuses_an_unknown_head_dim(cuda):
    """The f32 path's C entry point returns an error for a head dim it has
    no kernel for and launches nothing (not even the split pass)."""
    import ctypes
    from repro_torch.kernels import _build
    q = torch.ones((1, 2, 64, 48), device=cuda)
    out = torch.full_like(q, 7.0)
    planes = torch.full((2,) + q.shape, 3.0, device=cuda,
                        dtype=torch.bfloat16)
    dims = (ctypes.c_int64 * 6)(1, 2, 2, 64, 64, 48)
    strides = (ctypes.c_int64 * 12)(*(list(q.stride()[:3]) * 4))
    err = _build.load("flash_attention").flash_attention_split_launch(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(),
        *(planes.data_ptr(),) * 3, ctypes.addressof(dims),
        ctypes.addressof(strides), 1, -1, 0.0, 0.125,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err != 0 and bool((out == 7.0).all())
    assert bool((planes == 3.0).all())


@pytest.mark.cuda
def test_flash_attention_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 48), device=cuda)
    with pytest.raises(ValueError):                 # hd 48
        tfa.flash_attention(q, q, q)
    q = torch.zeros((1, 3, 8, 64), device=cuda)
    k = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError):                 # H % KV != 0
        tfa.flash_attention(q, k, k)
    with pytest.raises(TypeError):                  # f16
        tfa.flash_attention(*(t.half() for t in (k, k, k)))
    with pytest.raises(ValueError):                 # mixed devices
        tfa.flash_attention(k, k.cpu(), k)


# ---------------------------------------------------------------------------
# MoE grouped matmul (csrc/moe_gmm.cu)
# ---------------------------------------------------------------------------

# tests/test_kernels.py:12: f32 2e-4, bf16 3e-2
GMM_CASES = [
    # (E, C, d, f)
    (4, 128, 256, 512), (8, 100, 512, 384), (2, 257, 320, 640),  # sweep
    (16, 8, 4096, 640),          # the decode-dispatch floor C = 8
    (1, 1, 1, 1),
    (3, 7, 5, 9),                # d, f no multiple of 4: scalar loads
    (2, 64, 100, 96),            # vector loads in f32, scalar in bf16
    (2, 130, 64, 130),           # ragged C and f tiles
]


def _gmm_inputs(case, dtype, cuda, seed=0):
    E, C, d, f = case
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((E, C, d), generator=g) * 0.1
    w = torch.randn((E, d, f), generator=g) * 0.05
    return x.to(cuda, dtype), w.to(cuda, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_matches_plain_version(cuda, case, dtype):
    x, w = _gmm_inputs(case, dtype, cuda)
    before = tmg.launches
    got = tmg.gmm(x, w)
    again = tmg.gmm(x, w)
    torch.cuda.synchronize()
    assert tmg.launches == before + 2
    assert got.dtype == dtype and got.shape == case[:2] + case[3:]
    assert torch.equal(got, again)               # fixed order: repeatable
    want = tref.gmm_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[dtype])


# bf16 through the tensor-core kernel at C = 1, 8, 100, 257 and 1280 (E, C,
# d, f); d or f no multiple of 8 takes the FMA kernel
GMM_WGMMA_CASES = [(2, 1, 64, 64), (16, 8, 4096, 640), (8, 100, 512, 384),
                   (2, 257, 320, 640), (2, 1280, 256, 520)]
GMM_BF16_FMA_CASES = [(2, 64, 100, 96), (2, 64, 96, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_WGMMA_CASES + GMM_BF16_FMA_CASES,
                         ids=str)
def test_gmm_bf16_runs_the_kernel_its_path_names(cuda, case):
    E, C, d, f = case
    x, w = _gmm_inputs(case, torch.bfloat16, cuda)
    path = tmg.kernel_path(E, C, d, f, torch.bfloat16)
    assert path == ("wgmma" if case in GMM_WGMMA_CASES else "fma")
    before = dict(tmg.launches_by_path)
    got = tmg.gmm(x, w)
    again = tmg.gmm(x, w)
    torch.cuda.synchronize()
    assert tmg.launches_by_path == {
        p: before[p] + (2 if p == path else 0) for p in tmg.PATHS}
    assert got.dtype == torch.bfloat16 and got.shape == (E, C, f)
    assert torch.equal(got, again)               # fixed order: repeatable
    want = tref.gmm_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(),
                               **FA_TOL[torch.bfloat16])


# f32 through the tensor-core kernel (each operand split into bf16 hi + lo)
# at C = 1, 8, 100, 130, 257 and 1280, d ragged against the 32-deep stage
# (264) and f against the 256-wide tile (520, 136); widths no multiple of 8
# take the FMA kernel (E, C, d, f)
GMM_SPLIT_CASES = GMM_WGMMA_CASES + [(2, 130, 264, 136), (4, 128, 256, 512)]
GMM_F32_FMA_CASES = [(2, 64, 100, 96), (2, 64, 96, 100), (2, 100, 252, 260)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_SPLIT_CASES + GMM_F32_FMA_CASES,
                         ids=str)
def test_gmm_f32_runs_the_kernel_its_path_names(cuda, case):
    """f32 at model scales (unit x, w of stddev d^-0.5): the path
    ``kernel_path`` names, the f32 tolerance, bitwise repeats."""
    E, C, d, f = case
    g = torch.Generator().manual_seed(C + d)
    x = torch.randn((E, C, d), generator=g).to(cuda)
    w = (torch.randn((E, d, f), generator=g) / math.sqrt(d)).to(cuda)
    path = tmg.kernel_path(E, C, d, f, torch.float32)
    assert path == ("wgmma_split" if case in GMM_SPLIT_CASES else "fma")
    before = dict(tmg.launches_by_path)
    got = tmg.gmm(x, w)
    again = tmg.gmm(x, w)
    torch.cuda.synchronize()
    assert tmg.launches_by_path == {
        p: before[p] + (2 if p == path else 0) for p in tmg.PATHS}
    assert got.dtype == torch.float32 and got.shape == (E, C, f)
    assert torch.equal(got, again)               # fixed order: repeatable
    torch.testing.assert_close(got, tref.gmm_ref(x, w),
                               **FA_TOL[torch.float32])


@pytest.mark.cuda
def test_gmm_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, w = _gmm_inputs((2, 16, 32, 64), torch.float32, cuda)
    with pytest.raises(TypeError):                  # mixed dtypes
        tmg.gmm(x, w.to(torch.bfloat16))
    with pytest.raises(TypeError):
        tmg.gmm(x.half(), w.half())
    with pytest.raises(ValueError):                 # not contiguous
        tmg.gmm(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError):                 # mixed devices
        tmg.gmm(x, w.cpu())
    before = tmg.launches
    empty = tmg.gmm(x[:, :0].contiguous(), w)
    assert empty.shape == (2, 0, 64) and tmg.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_moe_gmm_through_the_kernel_matches_plain_and_grads(cuda, mlp_type):
    """Three launches (two for gelu) per expert FFN; the gradient goes
    through the plain version."""
    g = torch.Generator().manual_seed(2)
    x = (torch.randn((4, 100, 128), generator=g) * 0.3).to(cuda)
    gate, up = ((torch.randn((4, 128, 256), generator=g) * 0.05).to(cuda)
                for _ in range(2))
    down = (torch.randn((4, 256, 128), generator=g) * 0.05).to(cuda)
    leaves = [t.clone().requires_grad_() for t in (x, gate, up, down)]
    before = tmg.launches
    out = tops.moe_gmm(*leaves, mlp_type=mlp_type)
    assert tmg.launches == before + (3 if mlp_type == "swiglu" else 2)
    refs = [t.clone().requires_grad_() for t in (x, gate, up, down)]
    want = tref.moe_ffn_ref(*refs, mlp_type=mlp_type)
    torch.testing.assert_close(out, want, **FA_TOL[torch.float32])
    w = torch.randn(out.shape, generator=g).to(cuda)
    (out * w).sum().backward()
    (want * w).sum().backward()
    for got, ref in zip(leaves, refs):
        if ref.grad is None:
            assert got.grad is None
        else:
            torch.testing.assert_close(got.grad, ref.grad,
                                       **FA_TOL[torch.float32])


# ---------------------------------------------------------------------------
# Mamba2 SSD chunked scan (csrc/ssd_scan.cu)
# ---------------------------------------------------------------------------

# tests/test_kernels.py:104-107: f32 5e-4 (the cumsum and the sums run in
# another order); bf16 adds one bf16 ulp of the output to it
SSD_TOL = {torch.float32: dict(rtol=5e-4, atol=5e-4),
           torch.bfloat16: dict(rtol=2 ** -7, atol=5e-4)}
SSD_CASES = [
    # (B, S, H, P, N, chunk)
    (1, 64, 2, 32, 16, 16), (2, 96, 3, 64, 32, 32),
    (1, 256, 1, 64, 128, 64),            # the reference sweep
    (2, 1024, 4, 64, 128, 256),          # mamba2-780m's chunk and widths
    (1, 300, 3, 64, 64, 256),            # zamba2's N; ragged last chunk
    (2, 100, 2, 32, 16, 32),             # the reduced configs' widths
    (1, 10, 2, 8, 4, 32),                # S < chunk
    (1, 200, 2, 40, 256, 96),            # N at its limit, chunk % 64 != 0
    (1, 1, 1, 1, 1, 1),
]


def _ssd_inputs(case, cuda, dtype=torch.float32, seed=0):
    B, S, H, P, N, _ = case
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    A = -torch.exp(torch.randn((H,), generator=g) * 0.3)
    b = torch.randn((B, S, N), generator=g) * 0.5
    c = torch.randn((B, S, N), generator=g) * 0.5
    D = torch.linspace(0.5, 1.5, H)
    return (x.to(cuda, dtype), dt.to(cuda), A.to(cuda), b.to(cuda, dtype),
            c.to(cuda, dtype), D.to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_version(cuda, case, dtype):
    args = _ssd_inputs(case, cuda, dtype)
    chunk = case[-1]
    before = tss.launches
    y, st = tss.ssd_scan(*args, chunk=chunk)
    y2, st2 = tss.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert tss.launches == before + 2
    assert y.dtype == dtype and y.shape == args[0].shape
    assert st.dtype == torch.float32 and st.shape == (
        case[0], case[2], case[4], case[3])
    assert torch.equal(y, y2) and torch.equal(st, st2)   # no atomics
    want_y, want_st = tref.ssd_scan_ref(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(st, want_st, **SSD_TOL[torch.float32])


@pytest.mark.cuda
def test_ssd_scan_reads_model_layout_views(cuda):
    """x, b and c as slices of one (B, S, conv_dim) projection, as the
    Mamba2 block passes them: read through their strides, no copy, and the
    same result as on contiguous copies."""
    B, S, H, P, N = 2, 300, 4, 64, 32
    g = torch.Generator().manual_seed(1)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g).to(cuda)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not x.is_contiguous() and x.data_ptr() == xbc.data_ptr()
    _, dt, A, _, _, D = _ssd_inputs((B, S, H, P, N, 64), cuda)
    got = tss.ssd_scan(x, dt, A, b, c, D, chunk=64)
    same = tss.ssd_scan(x.contiguous(), dt, A, b.contiguous(),
                        c.contiguous(), D, chunk=64)
    for a, e in zip(got, same):
        assert torch.equal(a, e)


@pytest.mark.cuda
def test_ssd_scan_large_decay_stays_finite(cuda):
    """cs_i - cs_j for j > i far past exp's range (dt*A summing to about
    -500 within a chunk, as the model's fastest heads do): the gate selects
    before the exponent. (Where cs reaches the thousands, the f32 cumsum's
    order alone moves exp(cs_i - cs_j) by ~1e-3 relative, in the reference
    as here: the chunked form's own conditioning.)"""
    args = list(_ssd_inputs((1, 512, 2, 64, 64, 256), cuda))
    args[1] = args[1] * 2.5
    dA = args[1][0, :256] * args[2]
    assert float(dA.sum(0).min()) < -88.0           # exp(88) is past f32
    y, st = tss.ssd_scan(*args, chunk=256)
    want_y, want_st = tref.ssd_scan_ref(*args, chunk=256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    torch.testing.assert_close(y, want_y, **SSD_TOL[torch.float32])
    torch.testing.assert_close(st, want_st, **SSD_TOL[torch.float32])


@pytest.mark.cuda
def test_ops_ssd_scan_grads_through_plain_version(cuda):
    args = [t.clone().requires_grad_() for t in
            _ssd_inputs((2, 100, 3, 32, 16, 32), cuda)]
    before = tss.launches
    y, st = tops.ssd_scan(*args, chunk=32)
    assert tss.launches == before + 1
    refs = [t.detach().clone().requires_grad_() for t in args]
    want_y, want_st = tref.ssd_scan_ref(*refs, chunk=32)
    torch.testing.assert_close(y, want_y, **SSD_TOL[torch.float32])
    g = torch.Generator().manual_seed(3)
    wy = torch.randn(y.shape, generator=g).to(cuda)
    ws = torch.randn(st.shape, generator=g).to(cuda)
    ((y * wy).sum() + (st * ws).sum()).backward()
    ((want_y * wy).sum() + (want_st * ws).sum()).backward()
    for got, ref in zip(args, refs):
        torch.testing.assert_close(got.grad, ref.grad,
                                   **SSD_TOL[torch.float32])


# the model paths' shapes (chip_smoke.py's SSD_SHAPES): the mamba2-780m
# prefill, zamba2-7b's widths, a ragged S and S < chunk
SSD_MODEL_CASES = {
    "prefill": (2, 4096, 48, 64, 128, 256),
    "zamba2": (1, 4096, 112, 64, 64, 256),
    "ragged": (2, 4000, 48, 64, 128, 256),
    "short": (2, 100, 48, 64, 128, 256),
}


def _launched_path(call):
    """(result, the one path whose launch count ``call()`` raised)."""
    before = dict(tss.launches_by_path)
    out = call()
    moved = {p: tss.launches_by_path[p] - before[p] for p in tss.PATHS}
    assert sorted(moved.values()) == [0, 1], moved
    return out, max(moved, key=moved.get)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(SSD_MODEL_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_paths_at_the_model_shapes(cuda, label, dtype):
    """Both paths (f32 on the FMA path, bf16 on the wgmma path at these
    shapes) against the plain version, each result repeating bitwise."""
    case = SSD_MODEL_CASES[label]
    args = _ssd_inputs(case, cuda, dtype)
    chunk = case[-1]
    (y, st), path = _launched_path(
        lambda: tss.ssd_scan(*args, chunk=chunk))
    assert path == tss.kernel_path(*case, dtype)
    assert path == ("wgmma" if dtype == torch.bfloat16 else "fma")
    y2, st2 = tss.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(st, st2)
    want_y, want_st = tref.ssd_scan_ref(*args, chunk=chunk)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(st, want_st, **SSD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_launches_by_path_match_kernel_path(cuda, case, dtype):
    args = _ssd_inputs(case, cuda, dtype)
    _, path = _launched_path(lambda: tss.ssd_scan(*args, chunk=case[-1]))
    assert path == tss.kernel_path(*case, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_heads_share_c_b_but_not_the_gate(cuda, dtype):
    """Four heads with their own A and dt: the kernel matches the plain
    version, and the plain version with head 0's gate on every head is far
    outside the tolerance, so a kernel that shared the gate would fail."""
    case = (1, 512, 4, 64, 64, 256)
    x, dt, A, b, c, D = _ssd_inputs(case, cuda, dtype, seed=5)
    A = torch.tensor([-0.2, -1.0, -2.5, -0.05], device=cuda)
    dt = dt * torch.tensor([0.5, 1.0, 2.0, 4.0], device=cuda)
    assert len(set(A.tolist())) == 4
    (y, st), path = _launched_path(
        lambda: tss.ssd_scan(x, dt, A, b, c, D, chunk=256))
    assert path == ("wgmma" if dtype == torch.bfloat16 else "fma")
    want_y, want_st = tref.ssd_scan_ref(x, dt, A, b, c, D, chunk=256)
    torch.testing.assert_close(y.float(), want_y.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(st, want_st, **SSD_TOL[torch.float32])
    shared_y, _ = tref.ssd_scan_ref(x, dt[..., :1].expand_as(dt),
                                    A[:1].expand_as(A), b, c, D, chunk=256)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(shared_y.float(), want_y.float(),
                                   **SSD_TOL[dtype])


@pytest.mark.cuda
def test_ssd_scan_bf16_reads_model_layout_views(cuda):
    """The wgmma path reads x, b and c as slices of one bf16 projection
    through their strides, as the f32 path does."""
    B, S, H, P, N = 2, 300, 4, 64, 32
    g = torch.Generator().manual_seed(2)
    xbc = torch.randn((B, S, H * P + 2 * N), generator=g).to(cuda,
                                                             torch.bfloat16)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    b, c = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not x.is_contiguous() and x.data_ptr() == xbc.data_ptr()
    _, dt, A, _, _, D = _ssd_inputs((B, S, H, P, N, 64), cuda)
    got, path = _launched_path(
        lambda: tss.ssd_scan(x, dt, A, b, c, D, chunk=64))
    assert path == "wgmma"
    same = tss.ssd_scan(x.contiguous(), dt, A, b.contiguous(),
                        c.contiguous(), D, chunk=64)
    for a, e in zip(got, same):
        assert torch.equal(a, e)


@pytest.mark.cuda
def test_ssd_scan_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, dt, A, b, c, D = _ssd_inputs((1, 64, 2, 32, 16, 16), cuda)
    with pytest.raises(ValueError):                 # P > 64
        tss.ssd_scan(torch.zeros((1, 64, 2, 65), device=cuda), dt, A, b, c,
                     D, chunk=16)
    big = torch.zeros((1, 64, 257), device=cuda)
    with pytest.raises(ValueError):                 # N > 256
        tss.ssd_scan(x, dt, A, big, big, D, chunk=16)
    with pytest.raises(TypeError):                  # mixed dtypes
        tss.ssd_scan(x, dt, A, b.to(torch.bfloat16), c, D, chunk=16)
    with pytest.raises(TypeError):                  # f16
        tss.ssd_scan(x.half(), dt, A, b.half(), c.half(), D, chunk=16)
    with pytest.raises(ValueError):                 # mixed devices
        tss.ssd_scan(x, dt.cpu(), A, b, c, D, chunk=16)
    with pytest.raises(ValueError):                 # dt does not fit
        tss.ssd_scan(x, dt[:, :10], A, b, c, D, chunk=16)
    before = tss.launches
    y, st = tss.ssd_scan(x[:, :0], dt[:, :0], A, b[:, :0], c[:, :0], D,
                         chunk=16)
    assert y.shape == (1, 0, 2, 32) and not st.any()
    assert tss.launches == before                   # S = 0: nothing to run


# ---------------------------------------------------------------------------
# federated LM training: one reduced round on the card against the CPU
# ---------------------------------------------------------------------------

def _lm_trainer(dev, config, rounds, backend=None):
    """``FedAvgTrainer`` on reduced qwen1.5-0.5b at the LM specs' traffic
    (``launch/lm_train_timing.py``: 12 clients, 4 a round, b 4, seq 32,
    K_r-rounds) in its configuration ``config``, weights from seed 0, on
    ``backend`` (default local)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.lm_train_timing import lm_data, make_trainer
    from repro_torch.models import registry
    cfg = get_arch("qwen1.5-0.5b-reduced")
    return make_trainer(config, rounds, cfg,
                        registry.init(0, cfg, device=dev), lm_data(cfg),
                        device=dev, backend=backend)


@pytest.mark.cuda
def test_reduced_lm_round_on_the_card_matches_the_cpu(cuda):
    """One round with the int8 uplink (configuration a): the card runs
    ``int8_decompress_reduce`` (one launch a leaf), the CPU its plain
    version. Counters exact; losses within 1e-4; each parameter within
    1e-4 plus one quantisation step of its leaf's movement (/127)."""
    from repro_torch.optim import tree_leaves
    trainers = {dev: _lm_trainer(dev, "a", 1) for dev in ("cpu", "cuda")}
    init = [t.clone() for t in tree_leaves(trainers["cpu"].params)]
    before = tdc.launches["int8_decompress_reduce"]
    hs = {dev: tr.run(1) for dev, tr in trainers.items()}
    assert tdc.launches["int8_decompress_reduce"] == before + len(init)
    h, hc = hs["cuda"], hs["cpu"]
    for key in ("rounds", "k", "eta", "sgd_steps", "wall_clock_s",
                "uplink_mbit", "downlink_mbit"):
        assert getattr(h, key) == getattr(hc, key), key
    np.testing.assert_allclose(h.train_loss, hc.train_loss, rtol=1e-4,
                               atol=1e-4)
    for old, a, b in zip(init, tree_leaves(trainers["cpu"].params),
                         tree_leaves(trainers["cuda"].params)):
        step = float((a - old).abs().max()) / 127.0
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4 + step)


@pytest.mark.cuda
def test_reduced_lm_sequential_round_on_the_card_matches_the_cpu(
        cuda, nccl_meshes):
    """One round of configuration b (int8 up and down) on the mesh's
    sequential strategy (2 groups): on the card the module's one-rank NCCL
    mesh, one ``int8_decode_apply`` launch a leaf (the broadcast, once a
    round) and no ``int8_decompress_reduce``; on the CPU the same core
    without a mesh. Counters exact; losses within 1e-4; each parameter
    within 1e-4 plus one quantisation step of its leaf's movement
    (/127)."""
    from repro_torch.core.engine.backends import MeshBackend
    from repro_torch.optim import tree_leaves
    backends = {"cuda": MeshBackend(nccl_meshes["data"][0],
                                    strategy="sequential", groups=2),
                "cpu": MeshBackend(None, strategy="sequential", groups=2,
                                   device="cpu")}
    trainers = {dev: _lm_trainer(dev, "b", 1, backend=be)
                for dev, be in backends.items()}
    init = [t.clone() for t in tree_leaves(trainers["cpu"].params)]
    before = dict(tdc.launches)
    hs = {dev: tr.run(1) for dev, tr in trainers.items()}
    torch.cuda.synchronize()
    assert tdc.launches["int8_decode_apply"] == \
        before["int8_decode_apply"] + len(init)
    assert tdc.launches["int8_decompress_reduce"] == \
        before["int8_decompress_reduce"]
    h, hc = hs["cuda"], hs["cpu"]
    for key in ("rounds", "k", "eta", "sgd_steps", "wall_clock_s",
                "uplink_mbit", "downlink_mbit"):
        assert getattr(h, key) == getattr(hc, key), key
    np.testing.assert_allclose(h.train_loss, hc.train_loss, rtol=1e-4,
                               atol=1e-4)
    for old, a, b in zip(init, tree_leaves(trainers["cpu"].params),
                         tree_leaves(trainers["cuda"].params)):
        step = float((a - old).abs().max()) / 127.0
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4 + step)


@pytest.mark.cuda
def test_fixed_cohort_topk_rounds_repeat_bitwise(cuda):
    """fixed-cohort-topk's codec (cohort [0, 3, 5, 9], top-k 0.25, one
    residual slot a client) for 2 rounds, twice: params, residual slots and
    losses bit for bit, one ``topk_scatter_reduce`` launch a leaf."""
    from repro_torch.optim import tree_leaves
    runs = []
    for _ in range(2):
        tr = _lm_trainer(cuda, "c", 2)
        assert tr.engine.transport.ef_slots == 4
        before = tdc.launches["topk_scatter_reduce"]
        h = tr.run(2)
        leaves = tree_leaves(tr.params)
        assert tdc.launches["topk_scatter_reduce"] == before + 2 * len(leaves)
        runs.append((h.train_loss, leaves,
                     tree_leaves(tr.engine.transport_state)))
    (la, pa, sa), (lb, pb, sb) = runs
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert all(a.shape[0] == 4 and torch.equal(a, b)
               for a, b in zip(sa, sb))


# ---------------------------------------------------------------------------
# the spec-driven entry point: checkpoint, restore and resume on the card
# ---------------------------------------------------------------------------

SPECS = Path(__file__).resolve().parents[1] / "examples" / "specs"


def _spec_run(spec, rounds):
    from repro_torch.api import build
    from repro_torch.optim import tree_leaves
    exp = build(spec.with_overrides(f"fed.rounds={rounds}"))
    h = exp.run()
    return h.as_dict(), [t.cpu() for t in tree_leaves(exp.params)]


def _max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


@pytest.mark.cuda
def test_reduced_spec_resume_on_the_card_follows_the_repeat_rule(cuda,
                                                                 tmp_path):
    """Reduced ``local-int8-decayK`` through ``build`` on the card: 2
    rounds, ``save``, ``FederatedExperiment.restore``, resume to 4, against
    two uninterrupted 4-round runs. Counters exact; params and losses
    bitwise when the two uninterrupted runs are bitwise, else within their
    difference; 14 ``int8_decompress_reduce`` launches a round."""
    from repro_torch.api import ExperimentSpec, FederatedExperiment, build
    from repro_torch.optim import tree_leaves
    spec = ExperimentSpec.load(str(SPECS / "local-int8-decayK.json"))
    before = tdc.launches["int8_decompress_reduce"]
    exp = build(spec.with_overrides("fed.rounds=2"))
    exp.run()
    leaves = len(tree_leaves(exp.params))
    path = str(tmp_path / "ckpt")
    exp.save(path)
    again = FederatedExperiment.restore(path)
    assert again.trainer.device.type == "cuda"
    assert all(t.device.type == "cuda"
               for t in tree_leaves(again.trainer.engine.transport_state))
    h = again.trainer.run(4, resume=True).as_dict()
    params = [t.cpu() for t in tree_leaves(again.params)]
    assert tdc.launches["int8_decompress_reduce"] == before + 4 * leaves
    (sh, sp), (ph, pp) = _spec_run(spec, 4), _spec_run(spec, 4)
    for key in ("rounds", "k", "eta", "sgd_steps", "wall_clock_s",
                "uplink_mbit", "downlink_mbit"):
        assert h[key] == sh[key] == ph[key], key
    repeat, resume = _max_diff(sp, pp), _max_diff(params, sp)
    loss_repeat = max(abs(a - b) for a, b in zip(sh["train_loss"],
                                                 ph["train_loss"]))
    loss_resume = max(abs(a - b) for a, b in zip(h["train_loss"],
                                                 sh["train_loss"]))
    assert resume <= repeat and loss_resume <= loss_repeat, \
        (resume, repeat, loss_resume, loss_repeat)


@pytest.mark.cuda
def test_launcher_checkpoint_serves_bitwise_on_the_card(cuda, tmp_path):
    """``launch.train --spec fixed-cohort-topk.json --checkpoint`` on the
    card, then ``launch.serve --checkpoint``: the served params are the
    checkpoint's, bit for bit."""
    from repro_torch.launch import serve, train
    path = str(tmp_path / "ckpt")
    exp = train.main(["--spec", str(SPECS / "fixed-cohort-topk.json"),
                      "--rounds", "1", "--checkpoint", path])
    assert exp.trainer.engine.transport.ef_slots == 4
    res = serve.main(["--checkpoint", path, "--tokens", "4"])
    with np.load(f"{path}/arrays.npz") as data:
        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from walk(v, f"{prefix}{k}/")
                else:
                    yield f"{prefix}{k}", v
        served = dict(walk(res["params"], "params/"))
        assert sorted(served) == sorted(k for k in data
                                        if k.startswith("params/"))
        for k, v in served.items():
            assert v.device.type == "cuda"
            np.testing.assert_array_equal(v.cpu().numpy(), data[k])


# ---------------------------------------------------------------------------
# streaming cohorts and async folds: the kernels in their new regimes
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m", [8193, 2 ** 27 + 4])
def test_int8_decompress_reduce_at_one_row(cuda, m):
    """An async arrival's fold: one client row (N = 1) through the kernel,
    one launch, its plain version's result exactly (a single product in
    f32 rounds once either way), at an odd M (the one-column path) and at
    an M above 2^27 (the 4-column path)."""
    rng = np.random.default_rng(m)
    q = torch.tensor(rng.integers(-127, 128, size=(1, m)),
                     dtype=torch.int8).to(cuda)
    w = torch.tensor([0.0123], dtype=torch.float32, device=cuda)
    before = tdc.launches["int8_decompress_reduce"]
    got = tdc.int8_decompress_reduce(q, w)
    torch.cuda.synchronize()
    assert tdc.launches["int8_decompress_reduce"] == before + 1
    assert got.device.type == "cuda" and got.shape == (m,)
    assert torch.equal(got, tref.int8_decompress_reduce_ref(q, w))


@pytest.mark.cuda
def test_fedavg_reduce_tree_on_a_one_row_tail_slab(cuda):
    """A streamed round's tail slab of one client: the whole CIFAR100 tree
    in one launch at a weight that is the global one (1/25), not 1, bitwise
    the per-leaf kernel and within the f32 tolerance of the plain
    version."""
    from repro_torch.optim import tree_leaves, tree_map
    tree, _ = _tree_case("cifar100", np.random.default_rng(3), cuda)
    tail = tree_map(lambda v: v[:1].contiguous(), tree)
    w = torch.tensor([1.0 / 25.0], dtype=torch.float32, device=cuda)
    before = tfr.launches
    got = tree_leaves(tops.fedavg_reduce_tree(tail, w))
    torch.cuda.synchronize()
    assert tfr.launches == before + 1
    for x, g in zip(tree_leaves(tail), got):
        assert torch.equal(g, tfr.fedavg_reduce(x.reshape(1, -1), w)
                           .reshape(x.shape[1:]))
        torch.testing.assert_close(
            g, tref.fedavg_reduce_ref(x.reshape(1, -1), w)
            .reshape(x.shape[1:]), **TOL[torch.float32])


@pytest.mark.cuda
def test_narrow_cifar100_one_slab_round_is_bitwise_dense(cuda):
    """A narrow CIFAR100 round with the kernel aggregator, dense and as one
    slab of the whole cohort (``cohort_chunk`` = U), from one seed: params
    bitwise, one ``fedavg_reduce`` launch a round each. cuDNN runs
    deterministically (its default convolution algorithms are not bitwise
    from run to run)."""
    from repro_torch.configs import FedConfig, get_paper_task
    from repro_torch.core import FedAvgTrainer, RuntimeModel
    from repro_torch.data import make_paper_task
    from repro_torch.models import small
    from repro_torch.optim import tree_leaves
    task = get_paper_task("cifar100")
    data = make_paper_task("cifar100", np.random.default_rng(1),
                           num_clients=8, samples_per_client=16)
    init = small.cnn_init(torch.Generator().manual_seed(1), (32, 32, 3), 100,
                          channels=(8, 16), hidden=32)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for chunk in (None, 4):
            fed = FedConfig(total_clients=8, clients_per_round=4, k0=2,
                            batch_size=4, aggregator="kernel",
                            cohort_chunk=chunk)
            tr = FedAvgTrainer(lambda p, b: small.task_loss(p, task, b),
                               init, data, fed,
                               RuntimeModel(1.0, task.runtime, 4),
                               device=cuda)
            before = tfr.launches
            h = tr.run(2)
            torch.cuda.synchronize()
            assert tfr.launches == before + 2
            out.append((h.train_loss, tree_leaves(tr.params)))
    finally:
        torch.backends.cudnn.deterministic = old
    (la, pa), (lb, pb) = out
    assert la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


@pytest.mark.cuda
def test_peak_mb_reads_the_allocator_and_resets_it(cuda):
    """``core.mem`` on the card: the peak since the counter was last reset
    covers a tensor allocated and freed in between, and each reading
    resets the counter to what is allocated now."""
    from types import SimpleNamespace
    from repro_torch.core import engine_peak_mb, trainer_peak_mb
    engine = SimpleNamespace(device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    x = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    del x
    assert trainer_peak_mb(SimpleNamespace(engine=engine)) >= (
        base + (64 << 20)) / 1e6
    assert engine_peak_mb(engine) == torch.cuda.memory_allocated(cuda) / 1e6


# ---------------------------------------------------------------------------
# the vision-language model and serving while training on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_llava_prefill_shape(cuda, dtype):
    """llava-next-34b's attention at its prefill length (576 patch
    positions ahead of 3,520 tokens: S 4096), 56 heads over 8 kv heads
    (GQA 7:1), hd 128, one sequence: the path its dtype names, against the
    plain version."""
    case = (1, 56, 8, 4096, 4096, 128)
    q, k, v = _fa_inputs(case, dtype, cuda, seed=56)
    want_path = "wgmma" if dtype == torch.bfloat16 else "wgmma_split"
    assert tfa.kernel_path(128, dtype) == want_path
    before = dict(tfa.launches_by_path)
    got = tfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.launches_by_path == {
        p: before[p] + (p == want_path) for p in tfa.PATHS}
    want = tref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[dtype])
    if dtype == torch.bfloat16:
        del want
        _assert_bf16_rows_close(got, q, k, v, causal=True)


@pytest.mark.cuda
def test_reduced_llava_prefill_with_the_kernel_matches_without(cuda):
    """Reduced llava-next-34b, patch embeddings ahead of the tokens: the
    prefill through flash (one launch a layer) against the plain path on
    the card, logits and every K/V state."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import make_prefill_step
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves
    cfg = get_arch("llava-next-34b-reduced")
    params = registry.init(0, cfg, device=cuda)
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 80),
                                     generator=g).to(cuda),
             "patch_embeds": (torch.randn((2, cfg.num_patch_tokens,
                                           cfg.d_model), generator=g)
                              * 0.1).to(cuda)}
    before = tfa.launches
    with torch.no_grad():
        got, gst = make_prefill_step(cfg, use_kernel=True)(params, batch)
        assert tfa.launches == before + cfg.num_layers
        want, wst = make_prefill_step(cfg, use_kernel=False)(params, batch)
    assert tfa.launches == before + cfg.num_layers
    torch.testing.assert_close(got, want, **FA_TOL[torch.float32])
    for a, b in zip(tree_leaves(gst), tree_leaves(wst)):
        assert a.shape[2] == 80 + cfg.num_patch_tokens
        torch.testing.assert_close(a, b, **FA_TOL[torch.float32])


@pytest.mark.cuda
def test_serving_tick_over_a_trainer_on_the_card(cuda):
    """``serve-while-training.json`` (reduced) on the card for 4 rounds:
    the int8 wire kernels run each round, the loop ticks at rounds 2 and 4
    with the version of its round, the served tree is the q8 store's load
    of the reference clients hold, and each round's wall clock is the
    runtime model's times 1/(1 - rho)."""
    from repro_torch.api import ExperimentSpec, build
    from repro_torch.optim import tree_leaves
    spec = ExperimentSpec.load(str(Path(__file__).resolve().parents[1]
                                   / "examples" / "specs"
                                   / "serve-while-training.json"))
    exp = build(spec.with_overrides("fed.rounds=4"))
    tr = exp.trainer
    assert tr.device.type == "cuda" and tr.serving is not None
    leaves = len(tree_leaves(tr.params))
    before = dict(tdc.launches)
    h = exp.run()
    for name in ("int8_decompress_reduce", "int8_decode_apply"):
        assert tdc.launches[name] == before[name] + 4 * leaves, name
    assert h.serve_rounds == [2, 4] and h.serve_staleness == [2, 2]
    assert tr.serving.served_version == tr.store.version == 4
    ref = tr.engine.downlink_state["ref"]
    served = tr.serving.params
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(served),
        tree_leaves(tr.engine.downlink.load_tree(ref, like=tr.params))))
    assert served["embed"]["embedding"].device.type == "cuda"
    rho = spec.serve.qps * spec.serve.query_ms / 1e3
    walls = np.diff(h.wall_clock_s, prepend=0.0)
    base = [tr.runtime._base_seconds(k) for k in h.k]
    np.testing.assert_allclose(walls, np.array(base) / (1 - rho),
                               rtol=1e-12, atol=0)
    assert tr.store.serve_queries == pytest.approx(
        spec.serve.qps * h.wall_clock_s[-1], rel=1e-12)
    assert all(t > 0 for t in h.serve_tokens_per_sec)


# ---------------------------------------------------------------------------
# whole-bucket dispatch and the packed fleet on the card
# ---------------------------------------------------------------------------

def _bytes_equal(a, b):
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_bucket_of_four_is_four_one_round_buckets_on_the_card(cuda):
    """FEMNIST at paper width with the kernel aggregator and int8 both
    ways: one B = 4 bucket equals four B = 1 buckets bitwise (params,
    codec state, losses), the first records its allocator peak, and each
    round launches each wire kernel once a leaf."""
    from repro_torch.configs import get_paper_task
    from repro_torch.core.engine.round import RoundEngine
    from repro_torch.core.mem import executable_peak_bytes
    from repro_torch.data import make_paper_task, pipeline
    from repro_torch.models import small
    from repro_torch.optim import tree_leaves
    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=16, samples_per_client=32)
    bb = pipeline.bucket_batches(np.random.default_rng(1), data, n_rounds=4,
                                 k=3, clients_per_round=8, batch_size=8)
    etas = np.full(4, 0.05, np.float32)
    leaves = len(tree_leaves(small.init_task_model(0, task, device="cpu")))
    outs = []
    for spans in ([(0, 4)], [(i, i + 1) for i in range(4)]):
        eng = RoundEngine(lambda p, b: small.task_loss(p, task, b),
                          aggregator="kernel", transport="int8",
                          downlink="int8", device=cuda)
        p = small.init_task_model(0, task, device=cuda)
        firsts = []
        before = dict(tdc.launches)
        for lo, hi in spans:
            p, f, _, _ = eng.run_bucket(
                p, {k: v[lo:hi] for k, v in bb.batches.items()},
                bb.weights[lo:hi], etas[lo:hi], bb.active[lo:hi], ())
            firsts.append(f)
        torch.cuda.synchronize()
        for name in ("int8_decompress_reduce", "int8_decode_apply"):
            assert tdc.launches[name] - before[name] == 4 * leaves
        program = next(iter(eng.registry.executables()))
        assert executable_peak_bytes(program) > 0
        outs.append((tree_leaves(p) + tree_leaves(eng.transport_state)
                     + tree_leaves(eng.downlink_state), torch.cat(firsts)))
    (sa, fa_), (sb, fb) = outs
    assert len(sa) == len(sb)
    assert all(_bytes_equal(x, y) for x, y in zip(sa, sb))
    assert _bytes_equal(fa_, fb)


@pytest.mark.cuda
def test_packed_fleet_on_streams_equals_serial_on_the_card(cuda):
    """A k0 x codec sweep at FEMNIST paper width, packed on four streams
    and serial: every point's params, losses and history bitwise equal, the
    programs shared alike, and the wire kernels' launches exact under the
    threads."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.api.sweep import expand_sweep
    from repro_torch.launch import fleet
    from repro_torch.optim import tree_leaves
    base = ExperimentSpec().with_overrides(
        "data.kind=paper", "data.task=femnist", "data.clients=16",
        "data.samples_per_client=32", "fed.clients_per_round=8",
        "fed.rounds=3", "fed.batch_size=8", "fed.eta0=0.05",
        "fed.k_schedule=rounds", "fed.aggregator=kernel")
    built = {}
    build = fleet.build

    def recording(spec, **kw):
        exp = build(spec, **kw)
        built[(mode, spec.fed.k0, spec.transport.name)] = exp
        return exp

    fleet.build = recording
    results = {}
    try:
        for mode in ("packed", "serial"):
            pts = fleet.share_k_grid(expand_sweep(
                "fed.k0=6,8", "transport.name=none,int8", base=base))
            before = dict(tdc.launches)
            results[mode] = fleet.run_fleet(points=pts,
                                            packed=mode == "packed")
            torch.cuda.synchronize()
            results[mode].launches = {k: tdc.launches[k] - before[k]
                                      for k in before}
    finally:
        fleet.build = build
    packed, serial = results["packed"], results["serial"]
    assert (packed.compile_count, packed.shared_count,
            packed.dispatch_count) == (serial.compile_count,
                                       serial.shared_count,
                                       serial.dispatch_count)
    assert packed.launches == serial.launches
    assert packed.launches["int8_decompress_reduce"] > 0
    for (mode, k0, name), a in built.items():
        if mode != "packed":
            continue
        b = built[("serial", k0, name)]
        assert a.history.as_dict() == b.history.as_dict()
        assert all(_bytes_equal(x, y) for x, y in
                   zip(tree_leaves(a.params), tree_leaves(b.params)))


# ---------------------------------------------------------------------------
# shard-local MoE dispatch (moe_path="dispatch_sharded") on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_dispatch_sharded_through_the_kernel_matches_cpu(cuda, shards):
    """Reduced phi3.5-moe's prefill with ``moe_path="dispatch_sharded"``
    through the kernels on the card against the plain path on the CPU:
    one stacked ``moe_gmm`` call a layer (three ``gmm`` launches), logits
    and states within the f32 tolerance, every group's drops alike."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import make_prefill_step
    from repro_torch.models import moe, registry
    from repro_torch.optim import tree_leaves, tree_map
    from test_torch_mesh_ranks import dropped, routing_ids
    cfg = get_arch("phi3.5-moe-42b-a6.6b-reduced")
    params = registry.init(0, cfg, device="cpu")
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 64)), dtype=torch.int32)
    kw = dict(moe_path="dispatch_sharded", moe_shards=shards)
    cap = moe.capacity(cfg, tokens.numel() // shards)
    with routing_ids() as want_ids:
        want_logits, want_states = make_prefill_step(cfg, **kw)(
            params, {"tokens": tokens})
    before = tmg.launches
    with torch.no_grad(), routing_ids() as ids:
        logits, states = make_prefill_step(cfg, use_kernel=True, **kw)(
            tree_map(lambda t: t.to(cuda), params),
            {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    E = cfg.moe.num_experts
    want_drops = [dropped(i, shards, cap, E) for i in want_ids]
    drops = [dropped(i, shards, cap, E) for i in ids]
    assert tmg.launches - before == 3 * cfg.num_layers
    assert drops == want_drops
    torch.testing.assert_close(logits.cpu(), want_logits.detach(),
                               rtol=1e-3, atol=1e-3)
    for a, b in zip(tree_leaves(states), tree_leaves(want_states)):
        torch.testing.assert_close(a.cpu(), b.detach(), rtol=2e-4,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# the tensor-parallel prefill on two gloo ranks on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_tensor_parallel_prefill_on_two_gloo_ranks_on_the_card(cuda,
                                                                tmp_path):
    """Two gloo ranks spawned on the one card, a (1, 2) ("data", "model")
    mesh, ``use_kernel=True``: reduced qwen2-7b with the stream by
    sequence block (flash on each rank's 2 of 4 heads), reduced
    phi3.5-moe with a token group a rank (flash and three ``gmm``
    launches a layer on each rank's group) and reduced mamba2-780m with
    the stream whole (``ssd_scan`` on each rank's 4 of 8 heads), each
    rank's logits and states within the f32 tolerance of the one-process
    kernel prefill on the card, every launch counted on each rank."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import make_prefill_step
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves, tree_map
    from test_torch_mesh_ranks import spawn, tp_rank_body
    moe = dict(moe_path="dispatch_sharded", moe_shards=2,
               moe_spmd_axes=("model",))
    runs = {"qwen2-7b-reduced": ({"act_spec": (None, "model", None)},
                                 {"flash_attention": 2}),
            "phi3.5-moe-42b-a6.6b-reduced": (moe, {"flash_attention": 2,
                                                   "gmm": 6}),
            "mamba2-780m-reduced": ({}, {"ssd_scan": 2})}
    models, tokens = {}, {}
    for i, arch in enumerate(runs):
        cfg = get_arch(arch)
        models[arch] = (cfg, registry.init(torch.Generator().manual_seed(0),
                                           cfg, device="cpu"))
        tokens[arch] = torch.tensor(np.random.default_rng(i).integers(
            0, cfg.vocab_size, (2, 64)), dtype=torch.int32)
    ranks = spawn(tp_rank_body, 2, tmp_path, models,
                  [(arch, (1, 2), arch, {"tokens": tokens[arch]},
                    dict(kw, use_kernel=True))
                   for arch, (kw, _) in runs.items()], "cuda")
    for arch, (kw, want) in runs.items():
        cfg, params = models[arch]
        one = {k: v for k, v in kw.items()
               if k not in ("act_spec", "moe_spmd_axes")}
        with torch.no_grad():
            logits, states = make_prefill_step(cfg, use_kernel=True, **one)(
                tree_map(lambda t: t.to(cuda), params),
                {"tokens": tokens[arch].to(cuda)})
        for res in ranks:
            got, got_states, _, launches = res[arch]
            assert {k: v for k, v in launches.items() if v} == want
            torch.testing.assert_close(got, logits.cpu(), rtol=2e-4,
                                       atol=2e-4)
            for a, b in zip(tree_leaves(got_states), tree_leaves(states)):
                torch.testing.assert_close(a, b.cpu(), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_tensor_parallel_decode_on_two_gloo_ranks_on_the_card(cuda,
                                                               tmp_path):
    """Two gloo ranks spawned on the one card, a (1, 2) ("data", "model")
    mesh: reduced qwen2-7b (kv heads over "model", dispatch) and reduced
    mamba2-780m (SSM heads over "model", the conv window cut evenly)
    decode a teacher-forced prompt of 8 tokens from
    ``init_cache(mesh=)`` on the card; each rank's logits at every step
    and its gathered cache within the f32 tolerance of the one-process
    decode on the card, the ranks bit for bit alike, no kernel launched."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import make_serve_step
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves, tree_map
    from test_torch_mesh_ranks import spawn, tpd_rank_body
    archs = ("qwen2-7b-reduced", "mamba2-780m-reduced")
    models, tokens = {}, {}
    for i, arch in enumerate(archs):
        cfg = get_arch(arch)
        models[arch] = (cfg, registry.init(torch.Generator().manual_seed(0),
                                           cfg, device="cpu"))
        tokens[arch] = torch.tensor(np.random.default_rng(i).integers(
            0, cfg.vocab_size, (4, 8)), dtype=torch.int32)
    ranks = spawn(tpd_rank_body, 2, tmp_path, models,
                  [(arch, "decode", (1, 2), arch, tokens[arch],
                    dict(max_seq=8)) for arch in archs], "cuda")
    for arch in archs:
        cfg, params = models[arch]
        params = tree_map(lambda t: t.to(cuda), params)
        cache = registry.init_cache(params, cfg, 4, 8)
        step = make_serve_step(cfg)
        want = []
        with torch.no_grad():
            for pos in range(8):
                logits, cache = step(params, cache, tokens[arch][:, pos].to(
                    cuda), pos)
                want.append(logits.cpu())
        for res in ranks:
            got, got_cache, _, _, _, launches = res[arch]
            assert not any(launches)
            assert torch.equal(got, ranks[0][arch][0])
            torch.testing.assert_close(got, torch.stack(want), rtol=2e-4,
                                       atol=2e-4)
            for a, b in zip(tree_leaves(got_cache), tree_leaves(cache)):
                torch.testing.assert_close(a, b.cpu(), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_tensor_parallel_encdec_on_two_gloo_ranks_on_the_card(cuda,
                                                              tmp_path):
    """Two gloo ranks spawned on the one card, a (1, 2) ("data", "model")
    mesh: reduced whisper-tiny (both caches by kv heads, 2 of 4 a rank)
    prefills a prompt of 5 tokens over its 16 audio frames, then runs
    ``init_cache(mesh=)`` and decodes 8 teacher-forced tokens on the card;
    each rank's prefill logits, logits at every step and gathered cache
    within the f32 tolerance of the one-process steps on the card, the
    ranks bit for bit alike, no kernel launched."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import make_prefill_step, make_serve_step
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves, tree_map
    from test_torch_mesh_ranks import spawn, tpe_rank_body
    arch = "whisper-tiny-reduced"
    cfg = get_arch(arch)
    params = registry.init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 8)),
                          dtype=torch.int32)
    audio = torch.tensor(rng.normal(size=(4, cfg.encoder_seq, cfg.d_model))
                         .astype(np.float32) * 0.1)
    ranks = spawn(tpe_rank_body, 2, tmp_path, {arch: (cfg, params)},
                  [(arch, (1, 2), arch, tokens, audio, 5, 8)], "cuda")
    card = tree_map(lambda t: t.to(cuda), params)
    with torch.no_grad():
        prefill = make_prefill_step(cfg)(
            card, {"tokens": tokens[:, :5].to(cuda),
                   "audio_embeds": audio.to(cuda)})
        cache = registry.init_cache(card, cfg, 4, 8,
                                    audio_embeds=audio.to(cuda))
        step = make_serve_step(cfg)
        want = []
        for pos in range(8):
            logits, cache = step(card, cache, tokens[:, pos].to(cuda), pos)
            want.append(logits.cpu())
    for res in ranks:
        got_pl, got, got_cache, _, _, _, launches = res[arch]
        assert launches == 0
        assert torch.equal(got, ranks[0][arch][1])
        torch.testing.assert_close(got_pl, prefill.cpu(), rtol=2e-4,
                                   atol=2e-4)
        torch.testing.assert_close(got, torch.stack(want), rtol=2e-4,
                                   atol=2e-4)
        for a, b in zip(tree_leaves(got_cache), tree_leaves(cache)):
            torch.testing.assert_close(a, b.cpu(), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# tensor-parallel training on two gloo ranks on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_tensor_parallel_training_on_two_gloo_ranks_on_the_card(cuda,
                                                                tmp_path):
    """Two gloo ranks spawned on the one card, a (1, 2) ("data", "model")
    mesh: one round of reduced qwen2-7b through ``make_fed_train_step``
    with the stream by sequence block, on the parallel strategy (4
    clients vmapped, K = 2, the ``fedavg_reduce`` kernel aggregating) and
    on the sequential one (2 groups of 2); each rank's new params and
    mean loss within the f32 tolerance of the one-process round on the
    card, the ranks bit for bit alike."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import make_fed_train_step
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves, tree_map
    from test_torch_mesh_ranks import spawn, tpt_rank_body
    arch = "qwen2-7b-reduced"
    cfg = get_arch(arch)
    params = registry.init(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    rng = np.random.default_rng(0)
    runs = {"parallel": (dict(act_spec=(None, "model", None),
                              use_kernel_avg=True), (4, 2, 2)),
            "sequential": (dict(strategy="sequential",
                                act_spec=("data", "model", None)),
                           (2, 2, 2, 2))}
    cases = []
    for name, (kw, lead) in runs.items():
        tokens = rng.integers(0, cfg.vocab_size, lead + (16,),
                              dtype=np.int32)
        w = np.full(lead[:-2], 0.25, np.float32)
        cases.append((name, "round", (1, 2), arch, ({"tokens": tokens}, w,
                                                    0.05),
                      dict(kw, acc_dtype=torch.float32)))
    ranks = spawn(tpt_rank_body, 2, tmp_path, {arch: (cfg, params)}, cases,
                  "cuda")
    card = tree_map(lambda t: t.to(cuda), params)
    for name, _, _, _, (batches, w, eta), kw in cases:
        one = {k: v for k, v in kw.items() if k != "act_spec"}
        want, loss = make_fed_train_step(cfg, device="cuda", **one)(
            card, batches, w, eta)
        for res in ranks:
            got, got_loss, _, _, _ = res[name]
            torch.testing.assert_close(got_loss, float(loss), rtol=2e-4,
                                       atol=2e-4)
            for a, b, c in zip(tree_leaves(got), tree_leaves(want),
                               tree_leaves(ranks[0][name][0])):
                torch.testing.assert_close(a, b.cpu(), rtol=2e-4, atol=2e-4)
                assert torch.equal(a, c)
