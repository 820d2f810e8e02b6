"""Tensor-parallel training (``make_fed_train_step(mesh=..., act_spec=...,
attn_kv_spec=..., moe_spmd_axes=...)``, ROADMAP A15 (b)) against the
reference, on the CPU.

* (a) The block path's collectives (``kernels.collectives``: ``block_dim``,
  ``gather_dim`` both ways, ``reduce_scatter_sum``, ``all_reduce_sum``
  both ways, ``enter``) on spawned gloo ranks at 2 and 3 ranks, blocks of
  7 rows (uneven): each forward bit for bit the plain function it
  replaces, each gradient under ``torch.func.grad`` and under
  ``torch.func.vmap(grad)`` over 3 clients that of the same function
  computed whole in one process, the backward's collectives counted.
* (b) One local step's gradient, leaf by leaf, on the ranks, after
  ``sharding.ModelGrads`` makes it whole (shared spans summed, owned
  spans gathered), against ``jax.grad`` of the reference's
  ``registry.loss_fn``: reduced qwen2-7b at (1, 3) (a kv head two ranks'
  query heads read) and at (1, 2) with the stream by sequence and by d,
  ``attn_kv_spec`` over the key sequence, ``remat``; reduced
  phi3.5-moe with a token group a rank; reduced mamba2-780m; the 5-layer
  zamba2 hybrid; reduced llava with its patch prefix.
* (c) Rounds through ``make_fed_train_step`` on the (1, 2), (1, 3) and
  (2, 2) ("data", "model") meshes with the reference dry run's arguments
  (``src/repro/launch/dryrun.py:119-146``), both strategies, ``remat`` on
  and off, a sequential round with ``param_specs`` and a parallel one
  through the ``fedavg_reduce`` kernel's plain version, each held to
  ``jax.jit(make_fed_train_step(jcfg, strategy=..., acc_dtype=f32))``
  without the specs; the ranks bit for bit alike; the collectives by
  kind those the layout implies (``want_round_counts``).
* (d) A world of one rank, in this process: bit for bit the step without
  the specs, on both strategies, with no collective of its own.
* (e) Refusals by name, and the encoder-decoder ignoring the specs.

Weights are the reference's init through ``bridge.params_from_jax``;
rtol = atol = 2e-4. Rank bodies ``tpt_rank_body`` in
``tests/test_torch_mesh_ranks.py`` (no JAX); one spawn a world size.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distributed import strategies as jstrat
from repro.models import registry as jreg
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import make_fed_train_step, sharding
from repro_torch.kernels import collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import cycle_counts, cycle_spec
from repro_torch.optim import tree_leaves
from test_torch_mesh_ranks import spawn, tpt_rank_body
from test_torch_parity_helpers import flat
from test_torch_parity_helpers import one_torch_thread  # noqa: F401
from test_torch_tensor_parallel import HYBRID, configs

F32 = dict(rtol=2e-4, atol=2e-4)
MOE = dict(moe_path="dispatch_sharded", moe_shards=2,
           moe_spmd_axes=("model",))
SEQ_ACT, D_ACT = (None, "model", None), (None, None, "model")
ETA = 0.05
COLL_ROWS, COLL_COLS, CLIENTS = 7, 5, 3

_MODELS = {}


def model(name):
    """(port cfg, reference cfg, port params, reference params): the
    reference's init from key 0, through ``bridge.params_from_jax``
    (copied: a spawn moves the tensors' storage into shared memory)."""
    if name not in _MODELS:
        tcfg, jcfg = configs(name)
        jp = jreg.init(jax.random.PRNGKey(0), jcfg)
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _MODELS[name] = (tcfg, jcfg, jax.tree.map(lambda t: t.clone(), tp),
                         jp)
    return _MODELS[name]


def grad_batch(cfg, S=16, B=2, seed=0):
    """B x ``S`` tokens (after a vlm's patch embeddings) from numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.arch_type == "vlm":
        out["patch_embeds"] = rng.normal(size=(
            B, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    return out


def round_inputs(cfg, strategy, n=4, k=2, b=2, s=16, seed=0):
    """One round's tokens and weights (``tests/test_torch_sequential.py``'s
    ``_lm_round_inputs``; sequential: 2 groups)."""
    rng = np.random.default_rng(seed)
    lead = (2, n // 2, k, b) if strategy == "sequential" else (n, k, b)
    tokens = rng.integers(0, cfg.vocab_size, size=lead + (s,),
                          dtype=np.int32)
    return {"tokens": tokens}, np.full(lead[:-2], 1.0 / n, np.float32)


def layout_of(act):
    dim = next((i for i, e in enumerate(act or ()) if e == "model"), None)
    return {None: None, 1: "seq", 2: "d"}[dim]


# ---------------------------------------------------------------------------
# the collectives each layout implies
# ---------------------------------------------------------------------------

def _add(c, **kw):
    for k, v in kw.items():
        c[k] += v


def _sublayer(c, layout, fwd: bool):
    """A column- then row-parallel sublayer: its stream gather and its
    partial's reduce-scatter (their adjoints backward), or with the
    stream whole the partial's all-reduce (``enter``'s backward)."""
    if layout is None:
        _add(c, all_reduce=1)
    else:
        _add(c, all_gather_dim=1, reduce_scatter_dim=1)


def _moe(c, layout, spread, in_place, fwd: bool):
    """The MoE sublayer: nothing where the groups are the rank's own
    sequence block; where they spread, the stream gathered for them and
    their outputs gathered (backward: the gathered input's reduce-scatter
    or ``enter``'s all-reduce, and the stream block's all-gather);
    unspread, every token on every rank, the stream gathered whole."""
    if spread and in_place:
        return
    if spread and layout is None:
        _add(c, **({"all_gather_dim": 1} if fwd else {"all_reduce": 1}))
    elif spread:
        _add(c, **({"all_gather_dim": 2} if fwd else
                   {"all_gather_dim": 1, "reduce_scatter_dim": 1}))
    elif layout is not None:
        _add(c, all_gather_dim=1)


def _layer(c, cfg, ltype, layout, spread, in_place, fwd: bool):
    _sublayer(c, layout, fwd)
    if ltype == "mamba":
        _add(c, all_reduce=1)              # the gated norm's sum of squares
    elif cfg.moe is not None:
        _moe(c, layout, spread, in_place, fwd)
    else:
        _sublayer(c, layout, fwd)


def fake_rank(m, layout, rank=0):
    """What ``ModelGrads`` reads of a ``ModelRank``."""
    return types.SimpleNamespace(mesh=None, rank=rank, size=m, layout=layout)


def want_step_counts(cfg, params, act, m, kw, S):
    """One local step's collectives over ``"model"`` on a rank, forward
    and backward: each layer's sites (``_layer``), the stream's block and
    its final gather, the MoE aux's all-reduce where the groups spread,
    the stacked layers' forward again under ``remat``, and the sum of the
    shared spans (one all-reduce where there are any)."""
    layout = layout_of(act)
    shards = kw.get("moe_shards", 1)
    spread = cfg.moe is not None and shards > 1 and "moe_spmd_axes" in kw
    runs = [collectives.row_range(shards, m, j) for j in range(m)]
    in_place = spread and layout == "seq" and [
        (hi - lo) * S // shards for lo, hi in runs] == \
        collectives.range_sizes(S, m)
    spec = cycle_spec(cfg)
    n_cyc, n_tail = cycle_counts(cfg)
    stacked = [spec[i] for _ in range(n_cyc) for i in range(len(spec))]
    tail = [spec[i] for i in range(n_tail)]
    c = dict.fromkeys(("all_reduce", "all_gather_dim", "reduce_scatter_dim"),
                      0)
    passes = [True, False] + [True] * bool(kw.get("remat"))
    for i, fwd in enumerate(passes):
        for lt in stacked + (tail if i < 2 else []):
            _layer(c, cfg, lt, layout, spread, in_place, fwd)
    if layout is not None:
        _add(c, all_gather_dim=2)
    if spread:
        _add(c, all_reduce=1)
    grads = sharding.ModelGrads(cfg, fake_rank(m, layout), params, spread)
    _add(c, all_reduce=int(any(s.shared for s in grads.splits.values())))
    return c, sum(any(s.owned) for s in grads.splits.values())


def want_round_counts(cfg, params, shape, kw, S, n=4, k=2, b=2):
    """A round's collectives on a rank of the (data, model) mesh
    ``shape``: ``k`` local steps (the parallel strategy's clients vmapped,
    one collective for all; the sequential's one at a time, every rank
    every group), the owned leaves gathered once a client (a stack of
    clients at once on the parallel strategy; every step under
    ``param_specs``); the backend's own: a parallel round's aggregate, one
    all-reduce a leaf over ``"data"``; a sequential round's gradients
    split over ``"data"``, one all-reduce a leaf and one of the shares a
    step."""
    d, m = shape
    step, owned = want_step_counts(cfg, params, kw.get("act_spec"), m, kw,
                                   S)
    L = len(tree_leaves(params))
    seq = kw.get("strategy") == "sequential"
    steps = n * k if seq else k
    c = {key: v * steps for key, v in step.items()}
    gathers = owned * (n * k if kw.get("param_specs") else n if seq else 1)
    _add(c, all_gather_dim=gathers)
    if not seq:
        _add(c, all_reduce=L)
    elif d > 1 and b % d == 0:
        _add(c, all_reduce=n * k * (1 + L))
    return c


# ---------------------------------------------------------------------------
# the spawned cases
# ---------------------------------------------------------------------------

def coll_inputs(R, seed=0):
    """The collectives' inputs on R ranks: a whole X every rank holds
    alike (``block``, ``enter``), its row blocks (the gathers), a whole
    partial a rank (the sums); each also batched over CLIENTS clients;
    ``C`` read whole by every rank, ``Cr`` a rank's own."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))
    sizes = collectives.range_sizes(COLL_ROWS, R)
    shape = (COLL_ROWS, COLL_COLS)

    def per_op(lead):
        X = t(*lead, *shape)
        h = [t(*lead, *shape) for _ in range(R)]
        off = np.cumsum([0] + sizes)
        blocks = [X.narrow(len(lead), int(off[r]), sizes[r]).contiguous()
                  for r in range(R)]
        return {"block": [X] * R, "enter": [X] * R, "gather": blocks,
                "gather_partial": blocks, "reduce_scatter": h,
                "all_reduce": h, "all_reduce_partial": h}

    return {"sizes": sizes, "inputs": per_op(()),
            "batched": per_op((CLIENTS,)), "C": t(*shape),
            "Cr": [t(*shape) for _ in range(R)]}


def whole_grads(op, xs, C, Cr):
    """The gradient of each rank's input of the op's whole function in
    one process: F = the sum over ranks of each rank's scalar."""
    W = sum(Cr) if op in ("gather_partial", "all_reduce_partial",
                          "enter") else C
    if op in ("block", "enter"):
        X = xs[0].clone().requires_grad_()
        g, = torch.autograd.grad((torch.tanh(X) * W).sum(), X)
        return [g] * len(xs)
    leaves = [x.clone().requires_grad_() for x in xs]
    Y = torch.cat(leaves, 0) if op.startswith("gather") else sum(leaves)
    return list(torch.autograd.grad((torch.tanh(Y) * W).sum(), leaves))


# the collectives of each op's grad (forward and backward) on a rank
COLL_COUNTS = {"block": {"all_gather_dim": 1},
               "gather": {"all_gather_dim": 1},
               "gather_partial": {"all_gather_dim": 1,
                                  "reduce_scatter_dim": 1},
               "reduce_scatter": {"all_gather_dim": 1,
                                  "reduce_scatter_dim": 1},
               "all_reduce": {"all_reduce": 1},
               "all_reduce_partial": {"all_reduce": 2},
               "enter": {"all_reduce": 1}}

# (b): (key, shape, arch, act_spec, extra kw)
GRAD_CASES = [
    ("qwen2-seq-13", (1, 3), "qwen2-7b-reduced", SEQ_ACT, {}),
    ("qwen2-seq-remat", (1, 2), "qwen2-7b-reduced", SEQ_ACT,
     dict(remat=True)),
    ("qwen2-d", (1, 2), "qwen2-7b-reduced", D_ACT, {}),
    ("qwen2-kvseq", (1, 2), "qwen2-7b-reduced", SEQ_ACT,
     dict(attn_kv_spec=(None, "model", None, None))),
    ("phi-seq", (1, 2), "phi3.5-moe-42b-a6.6b-reduced", SEQ_ACT, MOE),
    ("mamba-none", (1, 2), "mamba2-780m-reduced", None, {}),
    ("mamba-d-13", (1, 3), "mamba2-780m-reduced", D_ACT, {}),
    ("hybrid-seq", (1, 2), HYBRID, SEQ_ACT, dict(remat=True)),
    ("llava-seq", (1, 2), "llava-next-34b-reduced", SEQ_ACT, {}),
]

# (c): (key, shape, arch, kw) with the dry run's arguments: act_spec over
# the sequence (batch "data" on the sequential strategy), the client axes
# on the parallel one, MoE token groups over "model"
ROUND_CASES = [
    ("qwen-par-kernel", (1, 2), "qwen1.5-0.5b-reduced",
     dict(act_spec=SEQ_ACT, client_spmd_axes=("data",),
          use_kernel_avg=True, remat=True)),
    ("qwen-seq", (1, 2), "qwen1.5-0.5b-reduced",
     dict(strategy="sequential", act_spec=("data", "model", None),
          remat=False)),
    ("qwen-seq-specs", (1, 2), "qwen1.5-0.5b-reduced",
     dict(strategy="sequential", act_spec=("data", "model", None),
          param_specs=True, remat=True)),
    ("phi-par", (1, 2), "phi3.5-moe-42b-a6.6b-reduced",
     dict(act_spec=SEQ_ACT, client_spmd_axes=("data",), remat=False,
          **MOE)),
    ("mamba-par", (1, 2), "mamba2-780m-reduced",
     dict(act_spec=D_ACT, remat=True)),
    ("qwen2-par-13", (1, 3), "qwen2-7b-reduced", dict(remat=False)),
    ("qwen2-par-22", (2, 2), "qwen2-7b-reduced",
     dict(act_spec=SEQ_ACT, client_spmd_axes=("data",), remat=True)),
    ("qwen2-seq-22", (2, 2), "qwen2-7b-reduced",
     dict(strategy="sequential", act_spec=("data", "model", None),
          remat=False)),
]


def _torch_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


_SPAWNED = {}


def spawned(world, tmp_path_factory):
    """Every rank's results of the world's cases, from one spawn."""
    if world not in _SPAWNED:
        cases = []
        if world in (2, 3):
            cases.append((f"coll{world}", "coll", (1, world), None,
                          coll_inputs(world), {}))
        for key, shape, arch, act, kw in GRAD_CASES:
            if shape[0] * shape[1] == world:
                cases.append((key, "grad", shape, arch, _torch_batch(
                    grad_batch(model(arch)[0])), dict(kw, act_spec=act)))
        for key, shape, arch, kw in ROUND_CASES:
            if shape[0] * shape[1] == world:
                inputs = round_inputs(model(arch)[0],
                                      kw.get("strategy", "parallel"))
                cases.append((key, "round", shape, arch, (*inputs, ETA),
                              dict(kw, acc_dtype=torch.float32)))
        models = {arch: (model(arch)[0], model(arch)[2])
                  for arch in {c[3] for c in cases if c[3] is not None}}
        _SPAWNED[world] = spawn(tpt_rank_body, world,
                                tmp_path_factory.mktemp(f"tpt{world}"),
                                models, cases)
    return _SPAWNED[world]


# ---------------------------------------------------------------------------
# (a) the collectives' gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3])
def test_collectives_forward_and_gradients(world, tmp_path_factory):
    """Each Function's forward is its plain function's bit for bit; its
    gradient under ``grad`` and under ``vmap(grad)`` over 3 clients is
    the whole function's in one process, at blocks of 7 rows over 2 and
    3 ranks; its backward's collectives are counted."""
    ranks = spawned(world, tmp_path_factory)
    case = coll_inputs(world)
    for op, want in COLL_COUNTS.items():
        xs = case["inputs"][op]
        g_want = whole_grads(op, xs, case["C"], case["Cr"])
        gv_want = [whole_grads(op, [x[i] for x in case["batched"][op]],
                               case["C"], case["Cr"])
                   for i in range(CLIENTS)]
        for r, res in enumerate(ranks):
            fwd_equal, g, gv, counts = res[f"coll{world}"][op]
            assert fwd_equal, (op, r)
            torch.testing.assert_close(g, g_want[r], **F32)
            torch.testing.assert_close(
                gv, torch.stack([w[r] for w in gv_want]), **F32)
            assert {k: v for k, v in counts.items() if v} == want, (op, r)


# ---------------------------------------------------------------------------
# (b) one local step's gradient, leaf by leaf
# ---------------------------------------------------------------------------

def _jax_grads(arch, batch, kw):
    _, jcfg, _, jp = model(arch)
    fn = jreg.loss_fn(jcfg, remat=kw.get("remat", False),
                      moe_path=kw.get("moe_path", "dispatch"),
                      moe_shards=kw.get("moe_shards", 1))
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: fn(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(jp)
    return float(loss), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_local_step_gradient_matches_reference(case, tmp_path_factory):
    """The rank's gradient of one local step, made whole by
    ``ModelGrads``, within 2e-4 of ``jax.grad`` of the reference's loss,
    leaf by leaf, the same on every rank bit for bit; its collectives
    those the layout implies (``want_step_counts``) and one all-gather a
    leaf with owned spans."""
    key, shape, arch, act, kw = case
    cfg = model(arch)[0]
    ranks = spawned(shape[0] * shape[1], tmp_path_factory)
    batch = grad_batch(cfg)
    j_loss, j_grads = _jax_grads(arch, batch, kw)
    S = batch["tokens"].shape[1] + (cfg.num_patch_tokens
                                    if cfg.arch_type == "vlm" else 0)
    kw = dict(kw, act_spec=act)
    want, owned = want_step_counts(cfg, model(arch)[2], act, shape[1], kw,
                                   S)
    want["all_gather_dim"] += owned          # the hook's gathers
    got0 = flat(ranks[0][key][0])
    assert sorted(got0) == sorted(flat(j_grads))
    for r, res in enumerate(ranks):
        grads, loss, counts = res[key]
        np.testing.assert_allclose(loss, j_loss, **F32)
        got = flat(grads)
        for name, want_g in flat(j_grads).items():
            np.testing.assert_allclose(got[name], want_g, **F32,
                                       err_msg=f"{key} rank {r} {name}")
            assert np.array_equal(got[name], got0[name]), (key, name)
        assert {k: counts[k] for k in want} == want, (key, r, counts)


# ---------------------------------------------------------------------------
# (c) rounds through make_fed_train_step
# ---------------------------------------------------------------------------

_JSTEPS = {}


def _jax_round(arch, kw):
    """The reference's jitted round without the specs, on the same
    weights and inputs."""
    strategy = kw.get("strategy", "parallel")
    jkw = dict(strategy=strategy, remat=kw["remat"],
               moe_path=kw.get("moe_path", "dispatch"),
               moe_shards=kw.get("moe_shards", 1),
               use_kernel_avg=kw.get("use_kernel_avg", False))
    key = (arch,) + tuple(sorted(jkw.items()))
    if key not in _JSTEPS:
        _, jcfg, _, jp = model(arch)
        batches, w = round_inputs(model(arch)[0], strategy)
        step = jax.jit(jstrat.make_fed_train_step(
            jcfg, acc_dtype=jnp.float32, **jkw))
        p, loss = step(jp, {k: jnp.asarray(v) for k, v in batches.items()},
                       jnp.asarray(w), jnp.float32(ETA))
        _JSTEPS[key] = (flat(jax.tree.map(np.asarray, p)), float(loss))
    return _JSTEPS[key]


@pytest.mark.parametrize("case", ROUND_CASES,
                         ids=[c[0] for c in ROUND_CASES])
def test_round_matches_reference_without_specs(case, tmp_path_factory):
    """One round on the ranks within 2e-4 of the reference's round
    without the specs, every rank's params bit for bit the others', the
    collectives by kind those the layout implies."""
    key, shape, arch, kw = case
    cfg = model(arch)[0]
    ranks = spawned(shape[0] * shape[1], tmp_path_factory)
    j_params, j_loss = _jax_round(arch, kw)
    want = want_round_counts(cfg, model(arch)[2], shape, kw, 16)
    p0 = flat(ranks[0][key][0])
    for r, res in enumerate(ranks):
        params, loss, counts, _, _ = res[key]
        np.testing.assert_allclose(loss, j_loss, **F32)
        got = flat(params)
        assert sorted(got) == sorted(j_params)
        for name, w in j_params.items():
            np.testing.assert_allclose(got[name], w, **F32,
                                       err_msg=f"{key} rank {r} {name}")
            assert np.array_equal(got[name], p0[name]), (key, r, name)
        assert {k: counts[k] for k in want} == want, (key, r, counts)


# ---------------------------------------------------------------------------
# (d) a world of one rank
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


ONE_RANK = [("qwen2-7b-reduced", "parallel",
             dict(act_spec=SEQ_ACT, attn_kv_spec=(None, "model", None, None),
                  client_spmd_axes=("data",), remat=True)),
            ("phi3.5-moe-42b-a6.6b-reduced", "parallel",
             dict(act_spec=D_ACT, remat=False, **MOE)),
            ("mamba2-780m-reduced", "sequential",
             dict(act_spec=("data", "model", None), remat=True))]


@pytest.mark.parametrize("arch,strategy,kw", ONE_RANK,
                         ids=[c[0] for c in ONE_RANK])
def test_one_rank_is_the_step_without_specs_bit_for_bit(mesh1, arch,
                                                        strategy, kw):
    """On a world of one rank the specs change no value and run no
    collective: the round with them is the round without them bit for
    bit, with the same collectives (the backend's own, over axes of one
    rank), none over ``"model"``."""
    cfg, _, params, _ = model(arch)
    batches, w = round_inputs(cfg, strategy)
    base = {k: v for k, v in kw.items()
            if k not in ("act_spec", "attn_kv_spec", "moe_spmd_axes")}
    runs = []
    for step_kw in (base, kw):
        for kind in collectives.counts:
            collectives.counts[kind] = 0
        step = make_fed_train_step(cfg, mesh=mesh1, strategy=strategy,
                                   acc_dtype=torch.float32, device="cpu",
                                   **step_kw)
        runs.append((step(params, batches, w, ETA),
                     dict(collectives.counts)))
    (want, want_counts), (got, counts) = runs
    assert torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[0]),
                                                 tree_leaves(want[0])))
    assert counts == want_counts
    assert counts["all_gather_dim"] == counts["reduce_scatter_dim"] == 0


# ---------------------------------------------------------------------------
# (e) refusals
# ---------------------------------------------------------------------------

class Mesh:
    """A DeviceMesh's names, sizes and device: (1, 2) ("data",
    "model")."""
    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    @staticmethod
    def size(i=None):
        return 2 if i is None else (1, 2)[i]


@pytest.mark.parametrize("strategy,kw,match", [
    ("parallel", dict(act_spec=(None, "tensor", None)),
     "act_spec.*names axis 'tensor'"),
    ("parallel", dict(act_spec=(None, "model", "model")),
     "act_spec.*names 'model' twice"),
    ("sequential", dict(act_spec=("model", None, None)),
     "act_spec.*'model' on the batch dim"),
    ("parallel", dict(act_spec=("data", "model", None)),
     "act_spec's batch axes.*parallel strategy"),
    ("parallel", dict(attn_kv_spec=("pod", "model", None, None)),
     "attn_kv_spec.*names axis 'pod'"),
    ("sequential", dict(moe_spmd_axes=("data",)),
     "moe_spmd_axes.*spread over the 'model' ranks")])
def test_train_step_refuses_what_it_cannot_place(strategy, kw, match):
    """A spec the layout cannot place is refused by name when the step is
    made, on either strategy, before any collective."""
    with pytest.raises(ValueError, match=match):
        make_fed_train_step(get_arch("phi3.5-moe-42b-a6.6b-reduced"),
                            mesh=Mesh(), strategy=strategy, **kw)


def test_train_step_refuses_other_client_axes_and_ignores_encdec_specs():
    """``client_spmd_axes`` must be the backend's client axes; the
    encoder-decoder's step takes specs it cannot use and ignores them, as
    the reference's loss does."""
    with pytest.raises(ValueError, match="client_spmd_axes"):
        make_fed_train_step(get_arch("qwen2-7b-reduced"), mesh=Mesh(),
                            act_spec=SEQ_ACT, client_spmd_axes=("model",))
    make_fed_train_step(get_arch("whisper-tiny-reduced"), mesh=Mesh(),
                        act_spec=(None, "x", None), moe_spmd_axes=("data",))


@pytest.mark.parametrize("remat", [True, False])
def test_encdec_train_step_matches_reference(remat):
    """Reduced whisper-tiny, one parallel round (2 clients, K 2, b 2)
    through ``make_fed_train_step`` on one device, ``remat`` on (the
    step's default: the encoder's and decoder's layers recomputed in the
    backward under ``torch.func``) and off, within 2e-4 of the
    reference's jitted round."""
    tcfg, jcfg, tparams, jp = model("whisper-tiny-reduced")
    rng = np.random.default_rng(0)
    lead = (2, 2, 2)
    batches = {"tokens": rng.integers(0, tcfg.vocab_size, lead + (8,),
                                      dtype=np.int32),
               "audio_embeds": (rng.normal(size=lead + (
                   tcfg.encoder_seq, tcfg.d_model)) * 0.1).astype(
                       np.float32)}
    w = np.full((2,), 0.5, np.float32)
    jstep = jax.jit(jstrat.make_fed_train_step(jcfg, remat=remat,
                                               acc_dtype=jnp.float32))
    jnew, jloss = jstep(jp, {k: jnp.asarray(v) for k, v in batches.items()},
                        jnp.asarray(w), jnp.float32(ETA))
    step = make_fed_train_step(tcfg, remat=remat, acc_dtype=torch.float32,
                               device="cpu")
    new, loss = step(tparams, batches, w, ETA)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    want = flat(jax.tree.map(np.asarray, jnew))
    got = flat(new)
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, **F32, err_msg=name)
