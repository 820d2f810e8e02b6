"""The tensor-parallel prefill (``make_prefill_step(mesh=...)``, ROADMAP
A15 (a)) against the reference, on the CPU.

* The compute blocks (``distributed.sharding``): every kv head owned once,
  each rank's kv block holding what its query heads read.
* Each module that holds a kernel, in one process over simulated ranks
  (``use_kernel`` both ways; on the CPU the kernels' plain versions run):
  ``attention``'s partial sums over head blocks (aligned, with a kv head
  several ranks compute, and off the group size, where its kv heads
  repeat) against the reference's ``attention``, ``mlp_apply`` on d_ff
  blocks for every ``mlp_type``, ``ssm_forward`` on blocks of SSM heads
  (the gated RMSNorm's sum of squares summed over the ranks) against the
  reference's ``ssm_forward``, and ``moe_dispatch_groups`` over each
  rank's run of
  token groups (a rank without one among them) against the reference's
  ``moe_apply_dispatch_sharded``; all within rtol = atol = 2e-4.
* A world of one rank, in this process: every reduced decoder arch under
  each ``act_spec`` form, ``attn_kv_spec`` and MoE token groups over
  ``"model"``, bit for bit the step without a mesh, no collective run.
* Spawned gloo ranks on (1, 2), (1, 4) and (2, 2) ``("data", "model")``
  meshes (rank bodies ``tp_rank_body`` in
  ``tests/test_torch_mesh_ranks.py``, no JAX; one spawn a world size for
  all of its meshes' cases): nine reduced archs and a 5-layer zamba2
  hybrid with its shared attention block, each with ``act_spec`` None,
  over the sequence and over d (on (2, 2) the batch of 3 over
  ``"data"``), ``attn_kv_spec`` over the key sequence where the
  reference's dry run sets it (KV % m != 0), MoE token groups m and 2m
  over ``("model",)``, and a sequence that does not divide among the
  ranks (15 positions, MoE at 3 token groups; ``ODD_ARCHS``); and, in
  the 4-rank spawn, (2, 2, 1) and (2, 1, 2) ``("pod", "data", "model")``
  meshes with the batch over ("pod", "data") (a batch rank without a
  row). Every rank's logits and decode states within rtol = atol = 2e-4
  of the reference's ``make_prefill_step`` on the same weights and of
  the port's one-process step, every rank bit for bit the others, and
  each rank's collectives by kind equal to the count the layout
  implies.
* Refusals: the train step is built on a mesh with ``act_spec``,
  ``attn_kv_spec`` and ``moe_spmd_axes`` (A15 (b),
  ``tests/test_torch_tp_train.py``) and refuses them malformed; the
  prefill refuses an axis the mesh lacks and ``"model"`` twice.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch as jget_arch
from repro.distributed import strategies as jstrat
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import (make_fed_train_step, make_prefill_step,
                                     sharding)
from repro_torch.kernels import collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import cycle_spec
from test_torch_mesh_ranks import spawn, tp_rank_body
from test_torch_parity_helpers import flat
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-4, atol=2e-4)
HYBRID = "zamba2-7b-reduced-hybrid5"
ARCHS = ["qwen1.5-0.5b-reduced", "qwen2-7b-reduced", "gemma2-27b-reduced",
         "nemotron-4-340b-reduced", "phi3.5-moe-42b-a6.6b-reduced",
         "mixtral-8x22b-reduced", "mamba2-780m-reduced", "zamba2-7b-reduced",
         HYBRID, "llava-next-34b-reduced"]
B = 3
SEQ, ODD = 16, 15              # positions a prefill: divides 2 and 4; not
ODD_SHARDS = 3                 # the odd sequence's MoE token groups
MESH_SHAPES = [(1, 2), (1, 4), (2, 2)]
# ("pod", "data", "model") meshes of 4 ranks, the batch over ("pod",
# "data") as the reference's dry run spreads it across pods (3 rows over
# 4 batch ranks leave one without a row)
POD_SHAPES = [(2, 2, 1), (2, 1, 2)]
POD_ARCHS = ("qwen2-7b-reduced", "mixtral-8x22b-reduced", HYBRID)
# the archs of the odd sequence: GQA, MoE with a window, the hybrid's
# shared block and mamba tail, a vlm's patch prefix
ODD_ARCHS = ("qwen2-7b-reduced", "mixtral-8x22b-reduced", HYBRID,
             "llava-next-34b-reduced")


def configs(name):
    """(port cfg, reference cfg); ``HYBRID`` is reduced zamba2-7b with the
    pattern (mamba, attn) over 5 layers, as ``tests/test_torch_ssm.py``'s:
    2 cycles through the shared attention block and a mamba tail."""
    if name != HYBRID:
        return get_arch(name), jget_arch(name)
    kw = dict(name=HYBRID, layer_pattern=("mamba", "attn"), num_layers=5)
    return (dataclasses.replace(get_arch("zamba2-7b-reduced"), **kw),
            dataclasses.replace(jget_arch("zamba2-7b-reduced"), **kw))


_MODELS = {}


def model(name):
    """(port cfg, reference cfg, port params, reference params): the
    port's init from seed 0, the same weights copied to the reference
    (``bridge.params_to_numpy``; the trees share their keys), built once.
    A copy: a spawn moves the tensors' storage into shared memory, so a
    view of the old storage would dangle."""
    if name not in _MODELS:
        tcfg, jcfg = configs(name)
        tp = treg.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
        jp = jax.tree.map(jnp.array, bridge.params_to_numpy(tp))
        _MODELS[name] = (tcfg, jcfg, tp, jp)
    return _MODELS[name]


def batch_of(cfg, S, seed=0):
    """B x ``S`` tokens from numpy, after a vlm's 16 patch embeddings."""
    rng = np.random.default_rng(seed)
    P = cfg.num_patch_tokens if cfg.arch_type == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (B, S)).astype(np.int32)}
    if P:
        out["patch_embeds"] = rng.normal(
            size=(B, P, cfg.d_model)).astype(np.float32)
    return out


def seq_of(cfg, S):
    """A case's positions: ``S``, or a vlm's patches and ``S`` tokens."""
    return S + (cfg.num_patch_tokens if cfg.arch_type == "vlm" else 0)


def moe_kw(cfg, shards):
    if cfg.moe is None:
        return {}
    return dict(moe_path="dispatch_sharded", moe_shards=shards,
                moe_spmd_axes=("model",))


_REFS = {}


def reference(arch, S, shards):
    """The reference's and the port's one-process prefills of one case:
    ((logits, states) numpy, (logits, states) tensors), built once."""
    tcfg, jcfg, tp, jp = model(arch)
    key = (arch, S, shards if tcfg.moe is not None else 1)
    if key not in _REFS:
        batch = batch_of(tcfg, S)
        kw = {k: v for k, v in moe_kw(tcfg, shards).items()
              if k != "moe_spmd_axes"}
        jl, js = jax.jit(jstrat.make_prefill_step(jcfg, **kw))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        with torch.no_grad():
            tl, ts = make_prefill_step(tcfg, **kw)(
                tp, {k: torch.tensor(v) for k, v in batch.items()})
        _REFS[key] = ((np.asarray(jl), flat(js)), (tl, ts))
    return _REFS[key]


def _states_close(got, want, **tol):
    g = flat(got)
    assert sorted(g) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(g[k], w, err_msg=k, **tol)


def _equal(a, b) -> bool:
    fa, fb = flat(a), flat(b)
    return sorted(fa) == sorted(fb) and all(
        np.array_equal(fa[k], fb[k]) for k in fa)


# ---------------------------------------------------------------------------
# compute blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV", [(4, 2), (4, 4), (8, 4), (12, 2), (32, 8),
                                  (6, 3), (16, 1)])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_head_blocks_own_every_kv_head_once(H, KV, m):
    """Query heads in ``row_range`` blocks; each rank's kv block holds the
    kv head every one of its query heads reads; the owned kv heads are
    disjoint, in rank order, and cover every kv head, each owned by the
    rank that holds its first query head; a block aligned to whole groups
    maps head i to kv i // G as the kernel does."""
    G = H // KV
    blocks = [sharding.head_block(H, KV, m, r) for r in range(m)]
    assert [b.q for b in blocks] == [collectives.row_range(H, m, r)
                                     for r in range(m)]
    owned = []
    for b in blocks:
        (h0, h1), (k0, k1), (o0, o1) = b.q, b.kv, b.own
        assert all(0 <= i < k1 - k0 for i in b.reads())
        assert [k0 + i for i in b.reads()] == [h // G for h in range(h0, h1)]
        assert k0 <= o0 <= o1 <= max(k1, o0)
        owned += list(range(o0, o1))
        assert all(h0 <= j * G < h1 for j in range(o0, o1))
        if h0 % G == 0 and h1 % G == 0 and h1 > h0:
            assert b.aligned
    assert owned == list(range(KV))


# ---------------------------------------------------------------------------
# modules over simulated ranks, in one process
# ---------------------------------------------------------------------------

ATTN_CASES = [(4, 2, 4), (8, 4, 3)]
_ATTN = {}


def attn_case(H, KV):
    """(port cfg, port params, input, positions, the reference's (out, (k,
    v))) of one head layout, built once."""
    if (H, KV) not in _ATTN:
        base = dict(num_heads=H, num_kv_heads=KV, head_dim=16,
                    sliding_window=None, attn_logit_softcap=30.0)
        tcfg = dataclasses.replace(get_arch("qwen2-7b-reduced"), **base)
        jcfg = dataclasses.replace(jget_arch("qwen2-7b-reduced"), **base)
        jp = jattn.attn_init(jax.random.PRNGKey(1), jcfg)
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        S = 24
        x = np.random.default_rng(0).normal(
            size=(2, S, tcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
        _ATTN[H, KV] = (tcfg, tp, x, pos, jax.jit(
            lambda p, x, pos: jattn.attention(p, jcfg, x, pos))(
                jp, jnp.asarray(x), jnp.asarray(pos)))
    return _ATTN[H, KV]


@pytest.mark.parametrize("H,KV,m", ATTN_CASES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_partials_sum_to_the_reference(H, KV, m, use_kernel):
    """Every rank's ``attention`` on its heads (q, k, v of its heads, flash or
    the plain path, ``wo`` row-parallel) summed over the ranks equals the
    reference's attention; the owned kv heads put together are its k and
    v, and ``kv_rows`` blocks put together along the sequence too. (8, 4)
    over 3 puts a rank's heads off the group size, so its kv heads
    repeat; (4, 2) over 4 has two ranks compute each kv head."""
    tcfg, tp, x, pos, (jout, (jk, jv)) = attn_case(H, KV)
    S = x.shape[1]
    blocks = [sharding.head_block(H, KV, m, r) for r in range(m)]
    assert any(not b.aligned for b in blocks) == ((H, KV, m) == (8, 4, 3))
    parts, ks, vs, krows = [], [], [], []
    for r, b in enumerate(blocks):
        out, (k, v) = tattn.attention(
            tp, tcfg, torch.tensor(x), torch.tensor(pos), heads=b,
            use_kernel=use_kernel)
        parts.append(out)
        ks.append(k)
        vs.append(v)
        lo, hi = collectives.row_range(S, m, r)
        krows.append(tattn.attention(
            tp, tcfg, torch.tensor(x), torch.tensor(pos), heads=b,
            use_kernel=use_kernel, kv_rows=(lo, hi))[1][0])
    np.testing.assert_allclose(sum(parts).numpy(), np.asarray(jout), **F32)
    np.testing.assert_allclose(torch.cat(ks, 2).numpy(), np.asarray(jk),
                               **F32)
    np.testing.assert_allclose(torch.cat(vs, 2).numpy(), np.asarray(jv),
                               **F32)
    np.testing.assert_allclose(torch.cat(krows, 1).numpy(), np.asarray(jk),
                               **F32)


@pytest.mark.parametrize("arch", ["qwen2-7b-reduced", "gemma2-27b-reduced",
                                  "nemotron-4-340b-reduced",
                                  "whisper-tiny-reduced"])
def test_mlp_partials_sum_to_the_reference(arch):
    """``mlp_apply`` on the d_ff blocks of 3 ranks (512 = 171 + 171 + 170)
    summed equals the reference's ``mlp_apply``: swiglu, geglu, relu2,
    gelu; one block of all of d_ff is the MLP without a block bit for
    bit."""
    jcfg = jget_arch(arch)
    d, f = 32, 512
    jp = jlayers.mlp_init(jax.random.PRNGKey(2), d, f, jcfg.mlp_type)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 5, d)).astype(np.float32)
    want = np.asarray(jlayers.mlp_apply(jp, jnp.asarray(x), jcfg.mlp_type))
    got = sum(tlayers.mlp_apply(tp, torch.tensor(x), jcfg.mlp_type,
                                ff=collectives.row_range(f, 3, r))
              for r in range(3))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert torch.equal(
        tlayers.mlp_apply(tp, torch.tensor(x), jcfg.mlp_type, ff=(0, f)),
        tlayers.mlp_apply(tp, torch.tensor(x), jcfg.mlp_type))


_SSM = {}


def ssm_case():
    """(port cfg, port params, input, the reference's (out, state)),
    built once."""
    if not _SSM:
        tcfg, jcfg = get_arch("mamba2-780m-reduced"), jget_arch(
            "mamba2-780m-reduced")
        jp = jssm.ssm_init(jax.random.PRNGKey(3), jcfg)
        u = np.random.default_rng(2).normal(
            size=(2, 40, tcfg.d_model)).astype(np.float32)
        _SSM["case"] = (tcfg, bridge.params_from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"), u,
            jax.jit(lambda p, u: jssm.ssm_forward(p, jcfg, u))(
                jp, jnp.asarray(u)))
    return _SSM["case"]


@pytest.mark.parametrize("m", [3, 5])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_partials_sum_to_the_reference(m, use_kernel):
    """``ssm_forward`` on each rank's block of the 8 SSM heads
    (3, 3, 2 over 3; 2, 2, 2, 1, 1 over 5), its sum of squares summed over
    the ranks: the partial outputs summed equal the reference's
    ``ssm_forward``, the heads' SSM states put together its state, and
    the conv states (x channels by head, then B and C once) its conv
    state; all heads on one rank, its sum of squares through an
    all-reduce of one rank, is the forward without heads bit for bit."""
    tcfg, tp, u, (jout, jst) = ssm_case()
    H, P = tcfg.ssm.n_heads(tcfg.d_model), tcfg.ssm.head_dim
    heads = [collectives.row_range(H, m, r) for r in range(m)]
    local = {}

    def record(r):
        def all_reduce(t):
            local[r] = t.clone()
            return t
        return all_reduce

    for r, h in enumerate(heads):        # the ranks' own sums of squares
        tssm.ssm_forward(tp, tcfg, torch.tensor(u), heads=h,
                         all_reduce=record(r), use_kernel=use_kernel)
    total = sum(local.values())
    outs = [tssm.ssm_forward(tp, tcfg, torch.tensor(u), heads=h,
                             all_reduce=lambda t: total,
                             use_kernel=use_kernel)
            for h in heads]
    np.testing.assert_allclose(sum(o for o, _ in outs).numpy(),
                               np.asarray(jout), **F32)
    np.testing.assert_allclose(torch.cat([s["ssm"] for _, s in outs],
                                         1).numpy(),
                               np.asarray(jst["ssm"]), **F32)
    xs = [s["conv"][..., :(h1 - h0) * P] for (_, s), (h0, h1) in
          zip(outs, heads)]
    conv = torch.cat(xs + [outs[0][1]["conv"][..., (heads[0][1]
                                                    - heads[0][0]) * P:]],
                     -1)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jst["conv"]), **F32)
    whole = tssm.ssm_forward(tp, tcfg, torch.tensor(u), heads=(0, H),
                             all_reduce=lambda t: t, use_kernel=use_kernel)
    plain = tssm.ssm_forward(tp, tcfg, torch.tensor(u),
                             use_kernel=use_kernel)
    assert torch.equal(whole[0], plain[0]) and _equal(whole[1], plain[1])


_MOE = {}


def moe_case(shards):
    """(port cfg, one MoE layer's port params, input, the reference's
    ``moe_apply_dispatch_sharded`` (y, aux) at ``shards`` groups), built
    once."""
    if shards not in _MOE:
        tcfg, jcfg, _, jp = model("phi3.5-moe-42b-a6.6b-reduced")
        jlp = jax.tree.map(lambda a: a[0], jp["stack"]["b0"]["moe"])
        x = np.random.default_rng(3).normal(
            size=(2, 24, tcfg.d_model)).astype(np.float32)
        _MOE[shards] = (tcfg, bridge.params_from_jax(
            jax.tree.map(np.asarray, jlp), device="cpu"), x,
            jax.jit(lambda p, x: jmoe.moe_apply_dispatch_sharded(
                p, jcfg, x, shards=shards))(jlp, jnp.asarray(x)))
    return _MOE[shards]


@pytest.mark.parametrize("shards,m", [(4, 2), (8, 4), (3, 4)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_group_runs_match_the_reference(shards, m, use_kernel):
    """Each rank's contiguous run of the ``shards`` token groups
    (``row_range``) through ``moe_dispatch_groups`` (one stacked expert
    FFN a rank), put back together along the sequence, equals the
    reference's ``moe_apply_dispatch_sharded`` on reduced phi3.5-moe's
    first layer, with its capacity drops; the mean of every rank's
    groups' aux losses is its aux. (3, 4) leaves rank 3 without a group:
    it computes nothing."""
    tcfg, tlp, x, (jy, jaux) = moe_case(shards)
    S_l = x.shape[1] // shards
    ys, auxs = [], []
    for r in range(m):
        g0, g1 = collectives.row_range(shards, m, r)
        y, aux = tmoe.moe_dispatch_groups(
            tlp, tcfg, torch.tensor(x[:, g0 * S_l:g1 * S_l]), g1 - g0,
            use_kernel=use_kernel)
        assert y.shape == (2, (g1 - g0) * S_l, tcfg.d_model)
        assert aux.shape == (g1 - g0,)
        ys.append(y)
        auxs.append(aux)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), np.asarray(jy),
                               **F32)
    np.testing.assert_allclose(float(torch.cat(auxs).mean()), float(jaux),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# a world of one rank: bit for bit the step without a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A gloo process group of one rank in this process, for the module,
    and its 1x1 ("data", "model") mesh."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield make_mesh((1, 1), ("data", "model"), "cpu")
    dist.destroy_process_group()


ONE_RANK_SPECS = [None, ("data", "model", None), (None, None, "model")]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_is_the_step_without_a_mesh_bit_for_bit(mesh1, arch):
    """Under each ``act_spec`` form, ``attn_kv_spec`` over the key
    sequence, and (MoE) token groups over ``("model",)``, with and
    without the kernels' wrappers, the tensor-parallel step on a world of
    one rank returns the one-device step's logits and states bit for bit
    and runs no collective; its outputs are within 2e-4 of the
    reference's."""
    tcfg, _, tp, _ = model(arch)
    batch = {k: torch.tensor(v) for k, v in batch_of(tcfg, SEQ).items()}
    ref = reference(arch, SEQ, 2)[0]
    for use_kernel in (False, True):
        kw = dict(moe_kw(tcfg, 2), use_kernel=use_kernel)
        with torch.no_grad():
            want = make_prefill_step(tcfg, **kw)(tp, batch)
        for act in ONE_RANK_SPECS:
            for kv in (None, (None, "model", None, None)):
                for kind in collectives.counts:
                    collectives.counts[kind] = 0
                got = make_prefill_step(tcfg, act_spec=act,
                                        attn_kv_spec=kv, mesh=mesh1,
                                        **kw)(tp, batch)
                assert torch.equal(got[0], want[0]), (act, kv)
                assert _equal(got[1], want[1]), (act, kv)
                assert not any(collectives.counts.values())
        np.testing.assert_allclose(got[0].numpy(), ref[0], **F32)
        _states_close(got[1], ref[1], **F32)


def test_one_rank_collectives_run_nothing(mesh1):
    """``all_gather_dim`` and ``reduce_scatter_dim`` over an axis of one
    rank are the identity and count nothing; ``range_sizes`` is
    ``row_range``'s lengths."""
    x = torch.arange(12.0).reshape(3, 4)
    for kind in collectives.counts:
        collectives.counts[kind] = 0
    assert collectives.all_gather_dim(x, mesh1, "model", 1, [4]) is x
    assert collectives.reduce_scatter_dim(x, mesh1, "model", 0) is x
    assert not any(collectives.counts.values())
    assert collectives.range_sizes(10, 4) == [3, 3, 2, 2]
    assert collectives.range_sizes(2, 4) == [1, 1, 0, 0]


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------

def mesh_cases(shape):
    """Every case of one mesh: (key, shape, arch, S, act_spec,
    attn_kv_spec, step kwargs); key = (shape, arch, S, act name, kv, MoE
    token groups)."""
    data, m = shape
    b = "data" if data > 1 else None
    acts = {"none": (b, None, None) if b else None,
            "seq": (b, "model", None), "d": (b, None, "model")}
    cases = []
    for arch in ARCHS:
        cfg = configs(arch)[0]
        moe = cfg.moe is not None
        for name, act in acts.items():
            groups = [m, 2 * m] if moe and name == "seq" else [m]
            for g in groups:
                cases.append(((shape, arch, SEQ, name, False, g), shape,
                              arch, SEQ, act, None, moe_kw(cfg, g)))
        if cfg.num_kv_heads % m:              # the reference's dry run
            cases.append(((shape, arch, SEQ, "seq", True, m), shape, arch,
                          SEQ, acts["seq"], (b, "model", None, None),
                          moe_kw(cfg, m)))
        if arch in ODD_ARCHS:
            cases.append(((shape, arch, ODD, "seq", False, ODD_SHARDS),
                          shape, arch, ODD, acts["seq"], None,
                          moe_kw(cfg, ODD_SHARDS)))
    return cases


def pod_cases(shape):
    """The cases of a ("pod", "data", "model") mesh: ``POD_ARCHS``, the
    stream by sequence block and whole, the batch over ("pod",
    "data")."""
    m, b = shape[-1], ("pod", "data")
    acts = {"none": (b, None, None), "seq": (b, "model", None)}
    return [((shape, arch, SEQ, name, False, m), shape, arch, SEQ, act,
             None, moe_kw(configs(arch)[0], m))
            for arch in POD_ARCHS for name, act in acts.items()]


def layer_counts(cfg):
    """(attention blocks, dense MLPs, MoE layers, mamba blocks)."""
    spec = cycle_spec(cfg)
    types = [spec[i % len(spec)] for i in range(cfg.num_layers)]
    attn = sum(t != "mamba" for t in types)
    moe = attn if cfg.moe is not None else 0
    return attn, attn - moe, moe, sum(t == "mamba" for t in types)


def want_counts(cfg, n_states, shape, act, kw, S):
    """Each rank's collectives by kind in one prefill, from the layout:
    a stream gather and a partial's reduce-scatter (or one all-reduce,
    the stream whole) a sublayer, a mamba norm's all-reduce, the last
    position's and the logits' gathers, one gather a state leaf, the MoE
    token groups' gathers unless they are the rank's own sequence
    block, the aux all-reduce once where the groups spread; then each
    batch gather over each batch axis of more than one rank."""
    *lead, m = shape
    layout = {None: None, 1: "seq", 2: "d"}[next(
        (i for i, e in enumerate(act or ()) if e == "model"), None)]
    # one batch gather an axis of more than one rank
    split = sum(n > 1 for n in lead) if act is not None and \
        act[0] is not None else 0
    A, D, M, Mb = layer_counts(cfg)
    shards = kw.get("moe_shards", 1)
    spread = m > 1 and shards > 1
    c = dict.fromkeys(collectives.counts, 0)
    if m > 1:
        sub = A + D + Mb
        if layout is None:
            c["all_reduce"] += sub
        else:
            c["all_gather_dim"] += sub + 1
            c["reduce_scatter_dim"] += sub
        c["all_reduce"] += Mb + spread * (M > 0)
        c["all_gather_dim"] += 1 + n_states
        runs = [collectives.row_range(shards, m, j) for j in range(m)]
        in_place = spread and layout == "seq" and not split and [
            (hi - lo) * S // shards for lo, hi in runs] == \
            collectives.range_sizes(S, m)
        if not in_place:
            c["all_gather_dim"] += M * ((layout is not None) + spread)
    c["all_gather_dim"] += split * (1 + n_states + M)
    return c


_SPAWNED = {}


def spawned(world, tmp_path_factory):
    """Every rank's results of the cases of the meshes of ``world`` ranks
    ((1, 2); (1, 4), (2, 2) and the pod meshes), from one spawn."""
    if world not in _SPAWNED:
        cases = [c for shape in MESH_SHAPES if shape[0] * shape[1] == world
                 for c in mesh_cases(shape)]
        if world == 4:
            cases += [c for shape in POD_SHAPES for c in pod_cases(shape)]
        models = {arch: (model(arch)[0], model(arch)[2])
                  for arch in {c[2] for c in cases}}
        rank_cases = [
            (key, shape, arch, {k: torch.tensor(v) for k, v in
                                batch_of(models[arch][0], S).items()},
             dict(kw, act_spec=act, attn_kv_spec=kv))
            for key, shape, arch, S, act, kv, kw in cases]
        _SPAWNED[world] = (cases, spawn(
            tp_rank_body, world, tmp_path_factory.mktemp(f"tp{world}"),
            models, rank_cases))
    return _SPAWNED[world]


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_gloo_ranks_match_the_reference_prefill(tmp_path_factory, shape,
                                                arch):
    """Each case of ``arch`` on ``shape``'s ranks (one spawn a world: 2
    ranks, and 4 ranks for both 4-rank meshes): every rank's logits and
    states within rtol = atol = 2e-4 of the reference's prefill and of
    the port's one-process step, the ranks bit for bit alike, and each
    rank's collectives exact."""
    cases, ranks = spawned(shape[0] * shape[1], tmp_path_factory)
    check_cases(shape, [c for c in cases if c[1] == shape and c[2] == arch],
                ranks)


@pytest.mark.parametrize("shape", POD_SHAPES)
def test_gloo_ranks_with_the_batch_over_pod_and_data(tmp_path_factory,
                                                     shape):
    """The batch of 3 over the ("pod", "data") ranks of a 4-rank mesh
    (one batch rank without a row; a gather a batch axis of more than one
    rank, the inner first), with 1 and 2 ``"model"`` ranks: as above, in
    the 4-rank spawn."""
    cases, ranks = spawned(4, tmp_path_factory)
    check_cases(shape, [c for c in cases if c[1] == shape], ranks)


def check_cases(shape, mine, ranks):
    """Each case against the reference's and the one-process prefill,
    the ranks alike, the collectives exact."""
    assert mine
    for key, _, arch, S, act, kv, kw in mine:
        cfg = model(arch)[0]
        (jl, js), (tl, ts) = reference(arch, S, kw.get("moe_shards", 1))
        n_states = len(flat(ts))
        want = want_counts(cfg, n_states, shape, act, kw, seq_of(cfg, S))
        for r, res in enumerate(ranks):
            logits, states, counts, _ = res[key]
            np.testing.assert_allclose(logits.numpy(), jl, err_msg=str(key),
                                       **F32)
            _states_close(states, js, **F32)
            np.testing.assert_allclose(logits.numpy(), tl.numpy(), **F32)
            _states_close(states, flat(ts), **F32)
            assert counts == want, (key, r, counts, want)
            if r:
                assert torch.equal(logits, ranks[0][key][0])
                assert _equal(states, ranks[0][key][1])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

class Mesh:
    """A DeviceMesh's names, sizes and device: (1, 4) ("data",
    "model")."""
    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    @staticmethod
    def size(i=None):
        return 4 if i is None else (1, 4)[i]


@pytest.mark.parametrize("kw", [dict(act_spec=(None, "model", None)),
                                dict(attn_kv_spec=(None, "model", None,
                                                   None)),
                                dict(moe_spmd_axes=("model",))])
def test_train_step_refuses_tensor_parallel_arguments(kw):
    """The train step takes each tensor-parallel argument (A15 (b)): on a
    (1, 4) mesh the step is built, on both strategies; the same argument
    malformed (an axis the mesh lacks) is refused by name, before any
    collective."""
    cfg = get_arch("phi3.5-moe-42b-a6.6b-reduced")
    name = next(iter(kw))
    moe = dict(moe_path="dispatch_sharded", moe_shards=2)
    for strategy in ("parallel", "sequential"):
        make_fed_train_step(cfg, mesh=Mesh(), strategy=strategy, **moe,
                            **kw)
    bad = {name: tuple("tensor" if e == "model" else e for e in kw[name])}
    with pytest.raises(ValueError, match=rf"{name}.*names axis 'tensor'"):
        make_fed_train_step(cfg, mesh=Mesh(), **moe, **bad)


@pytest.mark.parametrize("kw,match", [
    (dict(act_spec=(None, "tensor", None)), "names axis 'tensor'"),
    (dict(act_spec=(None, "model", "model")), "names 'model' twice"),
    (dict(attn_kv_spec=(None, ("model", "model"), None, None)),
     "names 'model' twice"),
    (dict(attn_kv_spec=("pod", "model", None, None)), "names axis 'pod'"),
    (dict(act_spec=("model", None, None)), "'model' on the batch dim"),
    (dict(act_spec=(None, "data", None)), "takes 'model' alone"),
    (dict(act_spec=(None, "model")), "3 entries"),
    (dict(act_spec=(None, "model", None),
          attn_kv_spec=("data", "model", None, None)), "differ from"),
    (dict(moe_spmd_axes=("data",)), "spread over the 'model' ranks"),
    (dict(moe_spmd_axes=("pod",)), "names axis 'pod'")])
def test_prefill_refuses_specs_it_cannot_place(kw, match):
    """The tensor-parallel prefill refuses, by name, a spec that names an
    axis the mesh lacks or ``"model"`` twice, and the layouts it does not
    compute; the refusal comes when the step is made, before any
    collective."""
    cfg = get_arch("qwen2-7b-reduced")
    with pytest.raises(ValueError, match=match):
        make_prefill_step(cfg, mesh=Mesh(), **kw)


def test_encdec_step_ignores_the_specs(mesh1, monkeypatch):
    """The encoder-decoder step ignores the specs, as the reference's
    (``src/repro/distributed/strategies.py:167-174``): specs it would
    refuse for a decoder arch are taken; and it computes on the mesh's
    ranks (``encdec.prefill_encdec`` on a ``DecodeRank`` of the step's
    mesh), on a world of one rank bit for bit the step without a mesh,
    no collective run."""
    from repro_torch.models import encdec as tencdec
    cfg = get_arch("whisper-tiny-reduced")
    bad = dict(act_spec=(None, "x", None), attn_kv_spec=("pod", "model"),
               moe_spmd_axes=("data",))
    make_prefill_step(cfg, mesh=Mesh(), **bad)
    params = treg.init(0, cfg, device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (2, 6)),
                                    dtype=torch.int32),
             "audio_embeds": torch.tensor(rng.normal(size=(
                 2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))}
    ranks, prefill = [], tencdec.prefill_encdec
    monkeypatch.setattr(tencdec, "prefill_encdec", lambda *a: (
        ranks.append(a[-1]), prefill(*a))[1])
    for kind in collectives.counts:
        collectives.counts[kind] = 0
    got = make_prefill_step(cfg, mesh=mesh1, **bad)(params, batch)
    assert not any(collectives.counts.values())
    assert [tp.mesh for tp in ranks] == [mesh1]
    with torch.no_grad():
        want = make_prefill_step(cfg)(params, batch)
    assert got.shape == (2, cfg.vocab_size) and torch.equal(got, want)
