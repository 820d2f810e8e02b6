"""The port's ``fedavg_reduce``: its plain version and CPU dispatch against the
reference's Pallas kernel (interpret mode) and oracle. Also the build's
staleness rule, the ``kernel_path`` routing of ``gmm`` and
``flash_attention``, and a plain emulation of the f32 tensor-core paths'
three-product bf16 split, which need no card. The CUDA kernels against their
plain versions are tests/test_torch_cuda.py."""
import math
import os

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
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

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


def _stack_tree(name, n, rng):
    """A task's paper model, client-stacked to N rows of numpy f32."""
    from repro_torch.configs import get_paper_task
    from repro_torch.models import small
    from repro_torch.optim import tree_map
    params = small.init_task_model(0, get_paper_task(name), device="cpu")
    return tree_map(lambda p: rng.normal(size=(n,) + tuple(p.shape))
                    .astype(np.float32), params)


@pytest.mark.parametrize("name,n", [("femnist", 3), ("sent140", 4),
                                    ("shakespeare", 2)])
def test_fedavg_reduce_tree_on_paper_task_trees(name, n):
    """The port's tree reduce (the plain version on the CPU) against the
    reference's (the Pallas kernel in interpret mode) on the other paper
    models, leaf by leaf, beside the CNN-shaped case above."""
    from repro_torch.optim import tree_map
    rng = np.random.default_rng(len(name) + n)
    stack = _stack_tree(name, n, rng)
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    want = jops.fedavg_reduce_tree(jax.tree.map(jnp.asarray, stack),
                                   jnp.asarray(w))
    got = tops.fedavg_reduce_tree(tree_map(torch.tensor, stack),
                                  torch.tensor(w))
    assert got.keys() == want.keys()
    for k, sub in stack.items():
        assert got[k].keys() == want[k].keys() == sub.keys()
        for kk, s in sub.items():
            assert tuple(got[k][kk].shape) == s.shape[1:]
            np.testing.assert_allclose(got[k][kk].numpy(),
                                       np.asarray(want[k][kk]),
                                       **TOL["float32"])


# ---------------------------------------------------------------------------
# the tree launch's table (csrc/fedavg_reduce.cu), planned in plain Python
# ---------------------------------------------------------------------------

# the leaves of each paper task that take the 16-byte path at paper N: the
# only ones with a block of threads for every SM at 4 columns a thread
PAPER_VEC_LEAVES = {"cifar100": {"fc.kernel"}, "femnist": {"fc1.kernel"},
                    "sent140": set(), "shakespeare": set()}


def _blocks(work):
    return min(-(-work // tfr.THREADS), tfr.MAX_BLOCKS)


def _check_plan(plan, leaves):
    """What every launch of a plan must hold: leaves of its dtype pair in
    the caller's order, blocks laid end to end from 0, each leaf's blocks
    covering its work."""
    firsts = 0
    for row in plan.leaves:
        m, dtype, out_dtype, _, _ = leaves[row.index]
        assert (dtype, out_dtype) == (plan.dtype, plan.out_dtype)
        assert row.m == m and row.first_block == firsts
        width = 16 // dtype.itemsize
        assert row.blocks == _blocks(m // width if row.vec else m)
        firsts += row.blocks
    assert plan.blocks == firsts
    assert [r.index for r in plan.leaves] == sorted(r.index
                                                    for r in plan.leaves)


@pytest.mark.parametrize("name", ["cifar100", "femnist", "sent140",
                                  "shakespeare"])
def test_plan_launches_one_launch_for_a_paper_tree(name):
    from repro_torch.configs import get_paper_task
    from repro_torch.models import small
    params = small.init_task_model(0, get_paper_task(name), device="cpu")
    paths = [(f"{k}.{kk}", v.numel()) for k, sub in params.items()
             for kk, v in sub.items()]
    leaves = [(m, torch.float32, torch.float32, 4096 * (i + 1), 512 * i)
              for i, (_, m) in enumerate(paths)]
    plans = tfr.plan_launches(leaves)
    assert len(plans) == 1 and len(plans[0].leaves) == len(paths)
    _check_plan(plans[0], leaves)
    assert {paths[r.index][0] for r in plans[0].leaves if r.vec} == \
        PAPER_VEC_LEAVES[name]


def test_plan_launches_groups_by_dtype_pair_in_order():
    f32, bf16 = torch.float32, torch.bfloat16
    pairs = [(f32, f32), (bf16, bf16), (f32, f32), (bf16, f32),
             (bf16, bf16), (bf16, f32)]
    leaves = [(2 ** 20, a, b, 0, 0) for a, b in pairs]
    plans = tfr.plan_launches(leaves)
    assert [(p.dtype, p.out_dtype) for p in plans] == [
        (f32, f32), (bf16, bf16), (bf16, f32)]
    assert [[r.index for r in p.leaves] for p in plans] == [
        [0, 2], [1, 4], [3, 5]]
    for p in plans:
        _check_plan(p, leaves)
        assert all(r.vec for r in p.leaves)      # 2^20 / 8 >= 132 x 256


def test_plan_launches_splits_a_group_of_more_than_max_leaves():
    count = 2 * tfr.MAX_LEAVES + 5
    leaves = [(100 + i, torch.float32, torch.float32, 0, 0)
              for i in range(count)]
    plans = tfr.plan_launches(leaves)
    assert [len(p.leaves) for p in plans] == [tfr.MAX_LEAVES,
                                              tfr.MAX_LEAVES, 5]
    assert [r.index for p in plans for r in p.leaves] == list(range(count))
    for p in plans:
        _check_plan(p, leaves)


def test_plan_launches_takes_the_one_column_path_off_the_16_byte_grid():
    """An offset view, an unaligned output or M off the 16-byte width runs
    one column a thread; so does a leaf too small to give every SM a block
    of threads at 4 columns a thread."""
    n, m = 3, 4 * tfr.VEC_MIN_GROUPS
    base = torch.zeros(n * m + 1)
    view = base[1:].view(n, m)                 # contiguous, 4 bytes off
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    aligned = torch.zeros(n, m)
    f32 = torch.float32
    cases = [((m, f32, f32, aligned.data_ptr(), 0), True),
             ((m, f32, f32, view.data_ptr(), 0), False),
             ((m, f32, f32, aligned.data_ptr(), 8), False),
             ((m + 2, f32, f32, aligned.data_ptr(), 0), False),
             ((m - 4, f32, f32, aligned.data_ptr(), 0), False),
             ((2 * m, torch.bfloat16, f32, 0, 0), True),
             ((2 * m - 8, torch.bfloat16, f32, 0, 0), False)]
    leaves = [leaf for leaf, _ in cases]
    plans = tfr.plan_launches(leaves)
    got = {r.index: r.vec for p in plans for r in p.leaves}
    assert got == {i: vec for i, (_, vec) in enumerate(cases)}
    for p in plans:
        _check_plan(p, leaves)
    # the CPU tree reads the offset view as it is, through the plain version
    w = torch.tensor([0.25, 0.25, 0.5])
    torch.testing.assert_close(tops.fedavg_reduce_tree({"v": view}, w)["v"],
                               tref.fedavg_reduce_ref(view, w))


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


# ---------------------------------------------------------------------------
# the build's staleness rule and the kernels' routing (pure: no card)
# ---------------------------------------------------------------------------

def test_build_is_stale_after_its_source_or_a_shared_header_changes(
        tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    src, header, lib = csrc / "k.cu", csrc / "hopper.cuh", build / "libk.so"
    for p in (src, header):
        p.write_text("// source\n")
    assert _build._stale("k")                         # never built
    lib.write_bytes(b"")

    def touch(path, t):
        os.utime(path, (t, t))

    for p in (src, header):
        touch(p, 1000)
    touch(lib, 2000)
    assert not _build._stale("k")
    touch(header, 3000)                               # the header moved on
    assert _build._stale("k")
    touch(lib, 4000)
    assert not _build._stale("k")
    touch(src, 5000)                                  # the source moved on
    assert _build._stale("k")
    touch(src, 1000)
    (csrc / "other.cuh").write_text("// another header\n")
    touch(csrc / "other.cuh", 6000)                   # any csrc/*.cuh counts
    assert _build._stale("k")


def _attention_configs():
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.models.transformer import cycle_spec
    cfgs = [get_arch(n) for n in ARCHS] + [get_arch(f"{n}-reduced")
                                           for n in ARCHS]
    return [c for c in cfgs if "attn" in cycle_spec(c)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_path_for_every_config(dtype):
    """bf16 takes the wgmma path at every config's head dim, f32 the
    wgmma_split path (bf16 hi + lo planes, three products); a head dim
    outside ``HEAD_DIMS`` is refused."""
    from repro_torch.kernels import flash_attention as tfa
    cfgs = _attention_configs()
    assert {c.head_dim for c in cfgs} <= set(tfa.HEAD_DIMS)
    assert {112, 128} <= {c.head_dim for c in cfgs}
    assert tfa.PATHS == ("wgmma", "wgmma_split")
    want = "wgmma" if dtype == "bfloat16" else "wgmma_split"
    for cfg in cfgs:
        assert tfa.kernel_path(cfg.head_dim, TORCH[dtype]) == want, cfg.name
    with pytest.raises(ValueError):
        tfa.kernel_path(48, TORCH[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_kernel_path_for_every_moe_config(dtype):
    """The gate/up and down calls of every MoE config's prefill (B 2 x S
    4096 and the reduced configs' B 2 x S 96) take the wgmma kernel in
    bf16 and the wgmma_split kernel in f32; widths that are no multiple of
    8 take the FMA kernel in either dtype."""
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.kernels import moe_gmm as tmg
    from repro_torch.models.moe import capacity
    cfgs = [get_arch(n) for n in ARCHS if ARCHS[n].moe is not None]
    cfgs += [get_arch(f"{c.name}-reduced") for c in cfgs]
    assert len(cfgs) == 4
    want = "wgmma" if dtype == "bfloat16" else "wgmma_split"
    for cfg in cfgs:
        E = cfg.moe.num_experts
        for tokens in (2 * 4096, 2 * 96):
            C = capacity(cfg, tokens)
            for d, f in ((cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)):
                assert tmg.kernel_path(E, C, d, f, TORCH[dtype]) == want
    for d, f in ((100, 64), (64, 100), (7, 9), (252, 260)):
        assert tmg.kernel_path(4, 128, d, f, TORCH[dtype]) == "fma"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_path_for_every_ssm_config(dtype):
    """The scan of every SSM config's prefill (B 2 x S 4096) takes the wgmma
    path in bf16 and the FMA path in f32; the reduced configs (chunk 32),
    S < 64 and widths off the 16-element grid take the FMA path; shapes
    that no path takes are refused."""
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.kernels import ssd_scan as tss
    full = [get_arch(n) for n in ARCHS if ARCHS[n].ssm is not None]
    assert {c.name for c in full} >= {"mamba2-780m", "zamba2-7b"}
    dt = TORCH[dtype]
    for cfg in full + [get_arch(f"{c.name}-reduced") for c in full]:
        s = cfg.ssm
        H = s.n_heads(cfg.d_model)
        P = s.d_inner(cfg.d_model) // H
        want = ("wgmma" if dtype == "bfloat16" and s.chunk_size % 64 == 0
                else "fma")
        assert tss.kernel_path(2, 4096, H, P, s.d_state, s.chunk_size,
                               dt) == want, cfg.name
        if cfg in full:
            assert want == ("wgmma" if dtype == "bfloat16" else "fma")
        else:
            assert want == "fma"
    for shape in ((2, 63, 48, 64, 128, 256), (1, 4096, 4, 40, 128, 256),
                  (1, 4096, 4, 64, 24, 256), (1, 4096, 4, 64, 128, 96)):
        assert tss.kernel_path(*shape, dt) == "fma"
    for shape in ((1, 64, 2, 65, 16, 64), (1, 64, 2, 64, 257, 64),
                  (1, 64, 2, 64, 16, 8192), (1, 64, 2, 64, 16, 0),
                  (1, 64, 70000, 64, 16, 64)):
        with pytest.raises(ValueError):
            tss.kernel_path(*shape, dt)


# ---------------------------------------------------------------------------
# the f32 tensor-core paths' split, emulated: each f32 operand v as bf16
# hi = bf16(v) and lo = bf16(v - hi), each product as hi.hi + hi.lo + lo.hi
# (csrc/hopper.cuh); products of bf16 values are exact, so f64 sums show
# what the split itself costs. It must sit within the unchanged f32
# tolerance with SPLIT_SPARE x to spare, where bf16 alone misses it.
# ---------------------------------------------------------------------------

SPLIT_SPARE = 5
# chip_smoke.py FLASH_QK_STD: scores span several units
FLASH_QK_STD = 1.6


def _split(t):
    """f32 t as its bf16 hi and lo, both widened to f64."""
    hi = t.to(torch.bfloat16)
    lo = (t - hi.float()).to(torch.bfloat16)
    return hi.double(), lo.double()


def _split_mm(a, b):
    """a @ b as the three products of the split, summed in f64."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _over_tol(got, want):
    """The largest |got - want| over the f32 tolerance, elementwise."""
    tol = TOL["float32"]
    bound = tol["atol"] + tol["rtol"] * want.abs()
    return float(((got.double() - want.double()).abs() / bound).max())


@pytest.mark.parametrize("d", [4096, 6400])
def test_three_product_split_keeps_gmm_within_f32_tolerance(d):
    """``gmm`` at gate/up and down depth (unit x, w of stddev d^-0.5, as
    the model's weights): the split's three products within a fifth of
    the f32 tolerance of ``gmm_ref``; hi.hi alone is not within it."""
    rng = np.random.default_rng(d)
    E, C, f = 2, 128, 512
    x = torch.from_numpy(rng.standard_normal((E, C, d), np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32))
    want = tref.gmm_ref(x, w)
    assert _over_tol(_split_mm(x, w), want) <= 1 / SPLIT_SPARE
    hi_only = x.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()
    assert _over_tol(hi_only, want) > 1


def _trunc32(t):
    """f64 t rounded toward zero to f32 (as the tensor cores round the f32
    sum of a wgmma), back in f64."""
    f = t.float()
    toward0 = torch.nextafter(f, torch.zeros_like(f))
    return torch.where(f.double().abs() > t.abs(), toward0, f).double()


@pytest.mark.parametrize("d", [4096, 6400])
def test_promoted_accumulation_keeps_gmm_within_f32_tolerance(d):
    """The ``"wgmma_split"`` gmm's sums as the card forms them: each k16
    step's three products added to a partial that is rounded toward zero
    to f32 after every product, and each 64-deep partial added into the
    f32 sum with rounding to nearest. That stays within a fifth of the
    f32 tolerance; one accumulator rounded toward zero over all of d (no
    promotion) is several times further off."""
    rng = np.random.default_rng(d)
    E, C, f = 2, 128, 512
    x = torch.from_numpy(rng.standard_normal((E, C, d), np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(np.float32))
    want = tref.gmm_ref(x, w)
    xh, xl = _split(x)
    wh, wl = _split(w)
    acc = torch.zeros((E, C, f))
    flat = torch.zeros((E, C, f), dtype=torch.float64)
    for s0 in range(0, d, 64):
        part = torch.zeros((E, C, f), dtype=torch.float64)
        for k0 in range(s0, s0 + 64, 16):
            for a, b in ((xh, wh), (xh, wl), (xl, wh)):
                prod = a[..., k0:k0 + 16] @ b[:, k0:k0 + 16]
                part = _trunc32(part + prod)
                flat = _trunc32(flat + prod)
        acc = acc + part.float()
    assert _over_tol(acc, want) <= 1 / SPLIT_SPARE
    err = lambda t: float((t.double() - want.double()).abs().max())
    assert err(flat) > 3 * err(acc)


def _split_attention(q, k, v, causal, window, softcap):
    """The f32 wgmma_split path's arithmetic: S from three products,
    scale, softcap and mask in f32, p = exp(s - max) split again for
    P.V's three products, the sum of p from the unsplit p."""
    B, H, S, hd = q.shape
    G = H // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = (_split_mm(q, k.transpose(-1, -2)).float()) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~tref.attention_mask(S, S, causal, window, "cpu"),
                      -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    ph, pl = _split(p)
    vh, vl = _split(v)
    o = ph @ vh + pl @ vh + ph @ vl
    return o / p.double().sum(-1, keepdim=True)


@pytest.mark.parametrize("variant", [("causal", None, None),
                                     ("window", 128, None),
                                     ("softcap", None, 5.0)],
                         ids=lambda v: v[0])
@pytest.mark.parametrize("hd", [64, 112, 192])
def test_three_product_split_keeps_flash_within_f32_tolerance(hd, variant):
    """Causal GQA attention at the configs' head dims 64, 112 (zamba2-7b)
    and 192 (nemotron-4-340b), q and k at stddev 1.6: the split path's
    arithmetic within a fifth of the f32 tolerance of
    ``flash_attention_ref``; bf16 alone is not within it."""
    _, window, softcap = variant
    rng = np.random.default_rng(hd)
    B, H, KV, S = 1, 4, 2, 512
    q, k, v = (torch.from_numpy(
        (rng.standard_normal(shape) * std).astype(np.float32))
        for shape, std in (((B, H, S, hd), FLASH_QK_STD),
                           ((B, KV, S, hd), FLASH_QK_STD),
                           ((B, KV, S, hd), 1.0)))
    kw = dict(causal=True, window=window, softcap=softcap)
    want = tref.flash_attention_ref(q, k, v, **kw)
    assert _over_tol(_split_attention(q, k, v, True, window, softcap),
                     want) <= 1 / SPLIT_SPARE
    rounded = [t.to(torch.bfloat16).float() for t in (q, k, v)]
    assert _over_tol(tref.flash_attention_ref(*rounded, **kw), want) > 1
