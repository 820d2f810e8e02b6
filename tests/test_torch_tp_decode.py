"""The tensor-parallel decode (``make_serve_step(mesh=...)``, ROADMAP A15
(c)) against the reference, on the CPU.

* Each module of the decode, in one process over simulated ranks (one
  thread a rank, collectives through a barrier): ``attention_decode`` and
  ``attention_decode_quant`` over every rest layout of the cache (kv heads,
  head dim, key sequence, key sequence over the batch axes and
  ``"model"``, whole), a ring cache whose writer moves from rank to rank
  and a window, their partials summed against the reference's decode; the
  mamba block's decode (``ssm_decode_step`` on the rank's heads, the SSM
  state by head or whole, the conv window cut evenly over its channels)
  against the reference's; every expert's d_ff block on ``dispatch`` and
  ``dense`` against the reference's MoE; all within rtol = atol = 2e-4.
* A world of one rank, in this process: every reduced decoder arch, for
  each cache variant (plain, ring, quant, long mode), bit for bit the
  step without a mesh, with no collective; the prefill's blocks too.
* Spawned gloo ranks (rank bodies ``tpd_rank_body`` in
  ``tests/test_torch_mesh_ranks.py``, no JAX; one spawn a world size) on
  (1, 2), (1, 3) (the key-sequence layout), (1, 4) (the head-dim layout
  for KV 2) and (2, 2) (a batch of 4 over "data", then 3, whole on each
  data rank): nine reduced archs and a 5-layer zamba2 hybrid, a prompt
  and 6 greedy tokens each, ring caches on gemma2 and mixtral (windows
  64, wrapped), quant on qwen2-7b, long mode on gemma2. Every rank's
  logits and gathered cache within rtol = atol = 2e-4 of the reference's
  ``jax.jit(make_serve_step(...))`` on the same weights and of the port's
  one-process step, the ranks bit for bit alike, each block the shape
  ``block_shape(cache_pspecs)`` gives, the collectives by kind those the
  layout implies. The prefill's states as blocks (``cache_blocks``),
  gathered, bit for bit its whole states; the dry run's cache bytes a
  rank equal to the blocks ``init_cache(mesh=)`` allocates.
* Refusals: a mesh without ``"model"``, a cache not laid out on the
  step's mesh; the train step on a mesh takes ``act_spec`` (A15 (b)) and
  refuses it malformed.
"""
import dataclasses
import threading

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
from repro.models import registry as jreg
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import (make_fed_train_step, make_prefill_step,
                                     make_serve_step, sharding)
from repro_torch.kernels import collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttrans
from test_torch_mesh_ranks import spawn, tpd_rank_body
from test_torch_parity_helpers import flat
from test_torch_parity_helpers import one_torch_thread  # noqa: F401
from test_torch_tensor_parallel import ARCHS, HYBRID, configs, model

F32 = dict(rtol=2e-4, atol=2e-4)
PROMPT, GREEDY, MAX_SEQ = 5, 6, 12     # 12 divides among 2, 3 and 4 ranks
# a ring cache wraps past gemma2's and mixtral's window of 64
RING_PROMPT, RING_SEQ = 60, 72
MESH_SHAPES = [(1, 2), (1, 3), (1, 4), (2, 2)]
RING_ARCHS = ("gemma2-27b-reduced", "mixtral-8x22b-reduced")


# ---------------------------------------------------------------------------
# simulated ranks: one thread a rank
# ---------------------------------------------------------------------------

class Sim:
    """``n`` ranks in ``n`` threads: ``exchange`` hands every rank every
    rank's tensor, in rank order."""

    def __init__(self, n):
        self.box, self.bar = [None] * n, threading.Barrier(n)

    def exchange(self, r, t):
        self.box[r] = t
        self.bar.wait()
        out = list(self.box)
        self.bar.wait()
        return out


def run_ranks(n, fn):
    """``fn(r, sim)`` on ``n`` threads; every rank's result."""
    sim, out, errs = Sim(n), [None] * n, []

    def go(r):
        try:
            out[r] = fn(r, sim)
        except BaseException as e:        # noqa: BLE001 - re-raised below
            errs.append(e)
            sim.bar.abort()

    threads = [threading.Thread(target=go, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


class SimRank:
    """The ``"model"`` rank API the decode's blocks call, over ``Sim``
    threads ``group`` (this rank's ``"model"`` group, in rank order)."""

    def __init__(self, sim, r, group):
        self.sim, self.r, self.group = sim, r, group
        self.size, self.rank = len(group), group.index(r)
        self.norm_reduce = self.all_reduce if self.size > 1 else None
        self.batch_count = 1

    def _mine(self, t):
        box = self.sim.exchange(self.r, t)
        return [box[g] for g in self.group]

    def gather(self, x, dim, sizes):
        return x if self.size == 1 else torch.cat(self._mine(x), dim)

    def all_reduce(self, x):
        if self.size == 1:
            return x
        parts = self._mine(x)
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out


# ---------------------------------------------------------------------------
# attention_decode over simulated ranks
# ---------------------------------------------------------------------------

# (layout, H, KV, hd, "model" ranks, "data" ranks, L, window, ring)
ATTN_DECODE = [
    ("kv", 8, 4, 16, 1, 1, 16, None, False),
    ("kv", 8, 4, 16, 2, 1, 16, None, False),
    ("kv", 8, 4, 16, 4, 1, 16, 5, False),
    ("hd", 8, 4, 24, 3, 1, 16, None, False),     # heads 3, 3, 2: unaligned
    ("hd", 8, 4, 24, 3, 1, 16, 5, False),
    ("seq", 8, 4, 16, 3, 1, 12, 12, True),       # the ring wraps: the
    ("seq", 6, 2, 16, 4, 1, 24, 5, False),       # writer moves each slot
    ("seq_batch", 8, 4, 16, 2, 2, 16, None, False),
    ("whole", 8, 4, 16, 5, 1, 16, None, False),  # rank 4 owns no kv head
]
RING_STEPS = 20                  # past the ring's 12 slots
_ATTN_CFG = {}


def attn_cfgs(H, KV, hd):
    if (H, KV, hd) not in _ATTN_CFG:
        base = dict(num_heads=H, num_kv_heads=KV, head_dim=hd,
                    sliding_window=None, attn_logit_softcap=30.0)
        jcfg = dataclasses.replace(jget_arch("qwen2-7b-reduced"), **base)
        jp = jattn.attn_init(jax.random.PRNGKey(5), jcfg)
        _ATTN_CFG[H, KV, hd] = (
            dataclasses.replace(get_arch("qwen2-7b-reduced"), **base), jcfg,
            bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu"), jp)
    return _ATTN_CFG[H, KV, hd]


def place_of(layout, r, m, n, L, KV, hd, heads, kv_sizes, sim):
    """Rank ``r``'s ``KVPlace`` (of ``n`` = data x model threads; model
    rank r % m) and its value blocks' shape (B omitted)."""
    mr, di = r % m, r // m
    group = [di * m + j for j in range(m)]

    def cat(t, dim, ranks):
        box = sim.exchange(r, t)
        return torch.cat([box[g] for g in ranks], dim)

    to_heads = None
    if m > 1:
        to_heads = lambda t: cat(t, t.dim() - 2, group)
    if layout == "kv":
        return tattn.KVPlace(L, 2, heads.own, to_heads), (L, KV // m, hd)
    if layout == "hd":
        s = hd // m
        return tattn.KVPlace(L, 3, (mr * s, (mr + 1) * s), to_heads,
                             lambda t, d: cat(t, d, group)), (L, KV, s)
    if layout in ("seq", "seq_batch"):
        blocks = n if layout == "seq_batch" else m
        idx = r if layout == "seq_batch" else mr
        everyone = list(range(n)) if layout == "seq_batch" else group
        s = L // blocks
        return tattn.KVPlace(L, 1, (idx * s, (idx + 1) * s), to_heads,
                             lambda t, d: cat(t, d, everyone)), (s, KV, hd)
    return tattn.KVPlace(L, None, (0, 0), to_heads), (L, KV, hd)


def whole_of(layout, blocks, m, n):
    """The whole cache leaf from every rank's block."""
    if layout == "kv":
        return torch.cat(blocks[:m], 2)
    if layout == "hd":
        return torch.cat(blocks[:m], 3)
    if layout == "seq":
        return torch.cat(blocks[:m], 1)
    if layout == "seq_batch":
        return torch.cat(blocks, 1)
    return blocks[0]


def _dequant(c):
    return {n: np.asarray(c[n], np.float32) * np.asarray(c[n + "s"])
            + np.asarray(c[n + "r"], np.float32) * np.asarray(c[n + "rs"])
            for n in ("k", "v")}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", ATTN_DECODE, ids=lambda c: "-".join(
    str(v) for v in c))
def test_attention_decode_partials_sum_to_the_reference(case, quant):
    """Every rank's ``attention_decode`` (``_quant``) on its heads and its
    cache blocks, a step a slot (20 for the ring): the partials of a ``"model"`` group summed
    equal the reference's output at every step, and the blocks put
    together its cache (the int8 caches dequantised: a value on a rounding
    boundary may round one step apart). The ring cache of 12 slots over
    3 key blocks wraps, so every rank writes in turn."""
    layout, H, KV, hd, m, data, L, window, ring = case
    tcfg, jcfg, tp, jp = attn_cfgs(H, KV, hd)
    n, B, steps = m * data, 2, RING_STEPS if ring else L
    xs = np.random.default_rng(7).normal(
        size=(steps, B, 1, tcfg.d_model)).astype(np.float32)
    kw = dict(window=window, ring=ring)
    shape = (B, L, KV, hd)
    if quant:
        jc = {k: jnp.zeros(shape, jnp.int8) for k in ("k", "kr", "v", "vr")}
        jc.update({k: jnp.ones(shape[:-1] + (1,), jnp.float32)
                   for k in ("ks", "krs", "vs", "vrs")})
        jstep = jax.jit(lambda p, x, c, pos: jattn.attention_decode_quant(
            p, jcfg, x, c, pos, **kw))
    else:
        jc = (jnp.zeros(shape), jnp.zeros(shape))
        jstep = jax.jit(lambda p, x, c, pos: (lambda o, k, v: (o, (k, v)))(
            *jattn.attention_decode(p, jcfg, x, *c, pos, **kw)))
    jouts = []
    for pos in range(steps):
        o, jc = jstep(jp, jnp.asarray(xs[pos]), jc, pos)
        jouts.append(np.asarray(o))
    kv_sizes = tuple(hi - lo for lo, hi in (
        tattn.head_block(H, KV, m, j).own for j in range(m)))

    def rank(r, sim):
        heads = tattn.head_block(H, KV, m, r % m)
        place, blk = place_of(layout, r, m, n, L, KV, hd, heads, kv_sizes,
                              sim)
        if quant:
            c = {k: torch.zeros((B,) + blk, dtype=torch.int8)
                 for k in ("k", "kr", "v", "vr")}
            c.update({k: torch.ones((B, L, KV, 1)) for k in
                      ("ks", "krs", "vs", "vrs")})
        else:
            c = {"k": torch.zeros((B,) + blk), "v": torch.zeros((B,) + blk)}
        outs = []
        for pos in range(steps):
            x = torch.tensor(xs[pos])
            if quant:
                o, _ = tattn.attention_decode_quant(
                    tp, tcfg, x, c, pos, heads=heads, place=place, **kw)
            else:
                o, _, _ = tattn.attention_decode(
                    tp, tcfg, x, c["k"], c["v"], pos, heads=heads,
                    place=place, **kw)
            outs.append(o)
        return outs, c

    res = run_ranks(n, rank)
    for d in range(data):
        for pos in range(steps):
            got = sum(res[d * m + j][0][pos] for j in range(m))
            np.testing.assert_allclose(got.numpy(), jouts[pos],
                                       err_msg=f"step {pos}", **F32)
    got = {k: whole_of(layout, [c[k] for _, c in res], m, n)
           for k in (("k", "kr", "v", "vr") if quant else ("k", "v"))}
    if quant:
        got.update({k: res[0][1][k] for k in ("ks", "krs", "vs", "vrs")})
        got, want = _dequant(got), _dequant(jc)
    else:
        want = dict(zip(("k", "v"), jc))
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=k, **F32)


def test_kv_blocks_are_the_owned_kv_heads():
    """Where the kv heads divide among the ``"model"`` ranks (the cache's
    kv-head layout), each rank's even block of kv heads is exactly the kv
    heads it owns and its query heads read, so its slot is written and
    its block read with no collective; over every (H, KV, m) of the
    archs' head counts."""
    seen = 0
    for H, KV in [(4, 2), (4, 4), (8, 4), (12, 2), (32, 8), (6, 3), (16, 1),
                  (16, 16), (28, 4), (32, 32), (48, 8), (56, 8), (96, 8)]:
        for m in range(1, 17):
            if KV % m:
                continue
            for r in range(m):
                b = tattn.head_block(H, KV, m, r)
                n = KV // m
                assert b.own == b.kv == (r * n, (r + 1) * n), (H, KV, m, r)
                assert b.aligned
                seen += 1
    assert seen > 100


# ---------------------------------------------------------------------------
# the mamba block and the MoE d_ff blocks over simulated ranks
# ---------------------------------------------------------------------------

SSM_STEPS = 6


@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_mamba_block_decode_matches_the_reference(m):
    """The mamba block's decode on each of ``m`` ranks (its SSM heads: 4,
    4 over 2; 3, 3, 2 over 3; 2 each over 4; 2, 2, 2, 1, 1 over 5) from
    its cache blocks in ``cache_pspecs``' layout: the SSM state by head
    where the 8 heads divide, else whole on every rank; the conv window
    (conv_dim 288) cut evenly where it divides (2, 3, 4), which is not
    the rank's channels (its x channels, then B and C), else whole.
    Every step's output equals the reference's block (norm, then
    ``ssm_decode_step``), and the blocks put together its states."""
    tcfg, jcfg, tparams, jparams = model("mamba2-780m-reduced")
    bp = ttrans._index(tparams["stack"], 0)["b0"]
    jbp = jax.tree.map(lambda a: a[0], jparams["stack"]["b0"])
    B = 2
    whole = treg.cache_specs(tcfg, B, 4, torch.float32)["stack"]["b0"]
    ms = sharding.MeshShape({"data": 1, "model": m})
    spec = {k: sharding.cache_pspecs(tcfg, {k: v}, ms)[k]
            for k, v in whole.items()}
    shapes = {k: tuple(v.shape[1:]) for k, v in whole.items()}
    xs = np.random.default_rng(8).normal(
        size=(SSM_STEPS, B, 1, tcfg.d_model)).astype(np.float32)

    def jblock(p, x, st):
        h, new = jssm.ssm_decode_step(
            p["ssm"], jcfg, jlayers.norm_apply(jcfg.norm_type, p["ln"], x),
            st)
        return x + h, new

    jstep = jax.jit(jblock)
    jst = {"ssm": jnp.zeros(shapes["ssm"]), "conv": jnp.zeros(
        shapes["conv"])}
    want = []
    for pos in range(SSM_STEPS):
        y, jst = jstep(jbp, jnp.asarray(xs[pos]), jst)
        want.append(np.asarray(y))

    def rank(r, sim):
        tp = SimRank(sim, r, list(range(m)))
        b = sharding.compute_blocks(tcfg, 1, m, r)
        st = {k: torch.zeros(sharding.block_shape(shapes[k], spec[k][1:],
                                                  ms)) for k in shapes}
        ys = []
        for pos in range(SSM_STEPS):
            y, _ = ttrans._block_decode(
                bp, tcfg, "mamba", torch.tensor(xs[pos]), st, pos, tp=tp,
                b=b, rest=({k: v[1:] for k, v in spec.items()}, None))
            ys.append(y)
        return ys, st

    res = run_ranks(m, rank)
    for pos in range(SSM_STEPS):
        for ys, _ in res:
            np.testing.assert_allclose(ys[pos].numpy(), want[pos], **F32)
    ssm_split = spec["ssm"][-3] == "model"
    conv_split = spec["conv"][-1] == "model"
    assert ssm_split == (m in (2, 4)) and conv_split == (m in (2, 3, 4))
    got_ssm = (torch.cat([st["ssm"] for _, st in res], 1) if ssm_split
               else res[0][1]["ssm"])
    got_conv = (torch.cat([st["conv"] for _, st in res], -1) if conv_split
                else res[0][1]["conv"])
    np.testing.assert_allclose(got_ssm.numpy(), np.asarray(jst["ssm"]),
                               **F32)
    np.testing.assert_allclose(got_conv.numpy(), np.asarray(jst["conv"]),
                               **F32)


@pytest.mark.parametrize("path", ["dispatch", "dense"])
@pytest.mark.parametrize("m", [1, 2, 3, 5])
def test_moe_ff_blocks_sum_to_the_reference(path, m):
    """Every expert's d_ff block of ``m`` ranks (512 over ``m``, gate and
    up columns, down rows) on one decode token a row: the partials summed
    equal the reference's MoE on ``path``; the router is whole, so every
    rank routes and (dispatch) drops alike; one block of all of d_ff is
    the layer without a block bit for bit."""
    tcfg, jcfg, tparams, jparams = model("phi3.5-moe-42b-a6.6b-reduced")
    p = ttrans._index(tparams["stack"], 0)["b0"]["moe"]
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["b0"]["moe"])
    x = np.random.default_rng(9).normal(size=(4, 1, tcfg.d_model)).astype(
        np.float32)
    jfn = jmoe.moe_apply_dense if path == "dense" else \
        jmoe.moe_apply_dispatch
    want = np.asarray(jax.jit(lambda p, x: jfn(p, jcfg, x)[0])(
        jp, jnp.asarray(x)))
    got = sum(tmoe.moe_apply(p, tcfg, torch.tensor(x), path=path,
                             ff=collectives.row_range(tcfg.d_ff, m, r))[0]
              for r in range(m))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert torch.equal(
        tmoe.moe_apply(p, tcfg, torch.tensor(x), path=path,
                       ff=(0, tcfg.d_ff))[0],
        tmoe.moe_apply(p, tcfg, torch.tensor(x), path=path)[0])


# ---------------------------------------------------------------------------
# the decode of every arch: references, tokens and expected collectives
# ---------------------------------------------------------------------------

def variants(arch, shape):
    """The cases of ``arch`` on ``shape``: (name, batch, options)."""
    out = [("plain", 4, dict(max_seq=MAX_SEQ))]
    if shape == (2, 2):
        out.append(("plain", 3, dict(max_seq=MAX_SEQ)))
    if arch in RING_ARCHS:
        out.append(("ring", 4, dict(max_seq=RING_SEQ, ring=True)))
    if arch == "qwen2-7b-reduced":
        out.append(("quant", 4, dict(max_seq=MAX_SEQ, quant=True)))
    if arch == "gemma2-27b-reduced":
        out.append(("long", 4, dict(max_seq=MAX_SEQ, ring=True,
                                    long_mode=True)))
    if arch == "phi3.5-moe-42b-a6.6b-reduced":
        out.append(("dense", 4, dict(max_seq=MAX_SEQ, moe_path="dense")))
    return out


def _opts(kw):
    return {k: kw[k] for k in ("ring", "long_mode") if k in kw}


_DECODES = {}


def decodes(arch, B, kw):
    """(tokens (B, T): a prompt and the port's one-process greedy ids,
    the one-process logits (T, B, V) and final cache, the reference's
    logits and final cache (numpy)), built once a case."""
    key = (arch, B, tuple(sorted(kw.items())))
    if key in _DECODES:
        return _DECODES[key]
    tcfg, jcfg, tp, jp = model(arch)
    prompt = RING_PROMPT if kw.get("ring") and kw["max_seq"] == RING_SEQ \
        else PROMPT
    rng = np.random.default_rng(len(_DECODES))
    toks = list(torch.tensor(rng.integers(0, tcfg.vocab_size, (B, prompt)),
                             dtype=torch.int32).T)
    moe_path = kw.get("moe_path", "dispatch")
    cache = treg.init_cache(tp, tcfg, B, kw["max_seq"],
                            quant=kw.get("quant", False), **_opts(kw))
    step = make_serve_step(tcfg, moe_path=moe_path, **_opts(kw))
    logits = []
    with torch.no_grad():
        for pos in range(prompt + GREEDY):
            got, cache = step(tp, cache, toks[pos], pos)
            logits.append(got)
            if pos >= prompt - 1 and len(toks) < prompt + GREEDY:
                toks.append(torch.argmax(got, -1).to(torch.int32))
    toks = torch.stack(toks, 1)
    jc = jreg.init_cache(jp, jcfg, B, kw["max_seq"],
                         quant=kw.get("quant", False), **_opts(kw))
    jstep = jax.jit(jstrat.make_serve_step(jcfg, moe_path=moe_path,
                                           **_opts(kw)))
    jlog = []
    for pos in range(toks.shape[1]):
        got, jc = jstep(jp, jc, jnp.asarray(toks[:, pos].numpy()),
                        jnp.int32(pos))
        jlog.append(np.asarray(got))
    _DECODES[key] = (toks, torch.stack(logits), cache, np.stack(jlog),
                     jax.tree.map(np.asarray, jc))
    return _DECODES[key]


def _cache_close(got, want, quant, **tol):
    """Caches compared by key path; int8 caches dequantised."""
    g, w = flat(got), flat(want)
    if quant:
        g, w = (_dequant_flat(t) for t in (g, w))
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def _dequant_flat(f):
    out = {}
    for k, v in f.items():
        base, name = k.rsplit("/", 2)[0], k.rsplit("/", 2)[1]
        if name in ("k", "v"):
            out[k] = (v.astype(np.float32) * f[f"{base}/{name}s/"]
                      + f[f"{base}/{name}r/"].astype(np.float32)
                      * f[f"{base}/{name}rs/"])
    return out


def layer_specs(cfg, shape, B, kw):
    """Every layer's cache spec tree on ``shape``'s mesh, in the decode's
    order (cycles, then the tail), and the mesh's ``MeshShape``."""
    names = ("pod", "data", "model")[-len(shape):]
    ms = sharding.MeshShape(shape, names)
    cache = treg.cache_specs(cfg, B, kw["max_seq"], torch.float32,
                             quant=kw.get("quant", False), **_opts(kw))
    specs = sharding.cache_pspecs(cfg, cache, ms)
    spec = ttrans.cycle_spec(cfg)
    n_cycles, n_tail = ttrans.cycle_counts(cfg)
    order = [specs["stack"][f"b{i}"] for _ in range(n_cycles)
             for i in range(len(spec))]
    order += [specs["tail"][f"b{i}"] for i in range(n_tail)]
    return order, ms


def want_counts(cfg, shape, B, kw):
    """Each rank's collectives by kind in one decode step, from the
    layout: a layer's two partials' all-reduces (a mamba layer's: its
    norm's and ``out_proj``'s); the new slot's kv heads gathered (int8
    values and f32 scales apart) unless the cache keeps kv heads over
    ``"model"`` (then only a quantised cache's scales); the cache's blocks
    gathered at use where the key sequence or head dim is split (one an
    axis of more than one rank); one gather of the conv window's blocks
    and its new row's x channels, a whole SSM state's heads; dispatch
    MoE's batch gather; the logits over the vocabulary and the batch."""
    order, ms = layer_specs(cfg, shape, B, kw)
    m = shape[-1]
    big = lambda axes: sum(ms.shape.get(a, 1) > 1 for a in axes)
    ba = sharding.serve_batch_axes(ms)
    split = B % sharding.entry_size(ms, ba) == 0
    batch_gathers = big(ba) if split else 0
    quant = kw.get("quant", False)
    moe = cfg.moe is not None and kw.get("moe_path", "dispatch") != "dense"
    c = dict.fromkeys(collectives.counts, 0)
    for spec in order:
        if m > 1:
            c["all_reduce"] += 2
        if "ssm" in spec:
            if m > 1:
                c["all_gather_dim"] += 1 + (spec["ssm"][-3] != "model")
            continue
        s_e, kv_e, hd_e = spec["k"][-3:]
        if kv_e == "model":
            c["all_gather_dim"] += int(quant and m > 1)
        else:
            c["all_gather_dim"] += (2 if quant else 1) if m > 1 else 0
            entry = hd_e if hd_e is not None else s_e
            c["all_gather"] += big(sharding._names(entry))
        if moe:                 # every attention layer of an MoE arch
            c["all_gather_dim"] += batch_gathers
    c["all_gather_dim"] += (m > 1) + batch_gathers
    return c


def layouts_seen(cfg, shape, B, kw):
    """The rest layouts of the case's K/V leaves, by name."""
    order, _ = layer_specs(cfg, shape, B, kw)
    names = set()
    for spec in order:
        if "k" in spec:
            s_e, kv_e, hd_e = spec["k"][-3:]
            names.add("kv" if kv_e == "model" else "hd" if hd_e == "model"
                      else "seq_batch" if isinstance(s_e, tuple)
                      else "seq" if s_e else "whole")
    return names


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


ONE_RANK_VARIANTS = [dict(), dict(ring=True), dict(quant=True),
                     dict(ring=True, long_mode=True)]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_is_the_decode_without_a_mesh_bit_for_bit(mesh1, arch):
    """For each cache variant, the decode on a world of one rank from
    ``init_cache(mesh=)`` returns the one-device step's logits at every
    step and its cache bit for bit, runs no collective and keeps the
    cache in place; the prefill's states as blocks are its whole states
    bit for bit."""
    tcfg, _, tp, _ = model(arch)
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (3, 10)), dtype=torch.int32)
    for variant in ONE_RANK_VARIANTS:
        quant = variant.get("quant", False)
        kw = {k: v for k, v in variant.items() if k != "quant"}
        want_c = treg.init_cache(tp, tcfg, 3, 10, quant=quant, **kw)
        got_c = treg.init_cache(tp, tcfg, 3, 10, quant=quant, mesh=mesh1,
                                **kw)
        assert isinstance(got_c, sharding.CacheBlocks)
        one = make_serve_step(tcfg, **kw)
        ranked = make_serve_step(tcfg, mesh=mesh1, **kw)
        for pos in range(10):
            with torch.no_grad():
                want, _ = one(tp, want_c, toks[:, pos], pos)
            for kind in collectives.counts:
                collectives.counts[kind] = 0
            got, same = ranked(tp, got_c, toks[:, pos], pos)
            assert same is got_c
            assert not any(collectives.counts.values())
            assert torch.equal(got, want), (kw, quant, pos)
        g, w = flat(dict(got_c)), flat(want_c)
        assert sorted(g) == sorted(w)
        assert all(np.array_equal(g[k], w[k]) for k in w), (kw, quant)
    batch = {"tokens": toks}
    if tcfg.arch_type == "vlm":
        batch["patch_embeds"] = torch.zeros((3, tcfg.num_patch_tokens,
                                             tcfg.d_model))
    with torch.no_grad():
        _, whole = make_prefill_step(tcfg)(tp, batch)
    _, blocks = make_prefill_step(tcfg, mesh=mesh1, cache_blocks=True)(
        tp, batch)
    g, w = flat(sharding.gather_cache(blocks)), flat(whole)
    assert sorted(g) == sorted(k for k in w if w[k].dtype != object)
    assert all(np.array_equal(g[k], w[k]) for k in g)


def test_serve_step_refuses_what_it_cannot_place(mesh1):
    """On a mesh the step refuses a cache that is not this rank's blocks
    on its mesh (a one-device cache), and a batch the cache was not laid
    out for; the blocks' layout names its mesh."""
    tcfg, _, tp, _ = model("qwen2-7b-reduced")
    step = make_serve_step(tcfg, mesh=mesh1)
    tok = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="init_cache"):
        step(tp, treg.init_cache(tp, tcfg, 2, 4), tok, 0)
    cache = treg.init_cache(tp, tcfg, 3, 4, mesh=mesh1)
    assert cache.layout.mesh is mesh1
    with pytest.raises(ValueError, match="a batch of 2 tokens"):
        step(tp, cache, tok, 0)


class NoModel:
    """A DeviceMesh's names: ("data",) only."""
    mesh_dim_names = ("data",)


def test_serve_step_refuses_a_mesh_without_model():
    """A mesh without a ``"model"`` axis is refused by name, for every
    arch: the encoder-decoder's step too, which decodes on the
    ``"model"`` ranks like the rest."""
    for arch in ("qwen2-7b-reduced", "whisper-tiny-reduced"):
        with pytest.raises(ValueError, match="no 'model' axis"):
            make_serve_step(get_arch(arch), mesh=NoModel())


class Mesh14:
    """A DeviceMesh's names, sizes and device: (1, 4) ("data",
    "model")."""
    mesh_dim_names = ("data", "model")
    device_type = "cpu"

    @staticmethod
    def size(i=None):
        return 4 if i is None else (1, 4)[i]


def test_train_step_still_refuses_tensor_parallel():
    """Tensor-parallel training is ROADMAP A15 (b), now ported: the train
    step is built on a (1, 4) mesh with ``act_spec`` over the sequence;
    what it still refuses by name is a spec the layout cannot place."""
    cfg = get_arch("qwen2-7b-reduced")
    make_fed_train_step(cfg, mesh=Mesh14(), act_spec=(None, "model", None))
    with pytest.raises(ValueError, match=r"act_spec.*names 'model' twice"):
        make_fed_train_step(cfg, mesh=Mesh14(),
                            act_spec=(None, "model", "model"))


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------

HANDOVER_ARCHS = ("qwen2-7b-reduced", "phi3.5-moe-42b-a6.6b-reduced",
                  "mamba2-780m-reduced", HYBRID)
HANDOVER_SEQ = 12
DRYRUN_CASES = [("qwen2-7b", "decode_32k"), ("gemma2-27b", "decode_32k"),
                ("nemotron-4-340b", "decode_32k"),
                ("mamba2-780m", "decode_32k"), ("zamba2-7b", "long_500k"),
                ("mixtral-8x22b", "long_500k"),
                ("whisper-tiny", "decode_32k")]


def handover_kw(cfg, shape):
    b = "data" if shape[0] > 1 else None
    kw = dict(act_spec=(b, "model", None))
    if cfg.moe is not None:
        kw.update(moe_path="dispatch_sharded", moe_shards=shape[-1],
                  moe_spmd_axes=("model",))
    return kw


def mesh_cases(shape):
    """Every case of one mesh: (key, kind, shape, arch, tokens, kw)."""
    cases = []
    for arch in ARCHS:
        for name, B, kw in variants(arch, shape):
            toks = decodes(arch, B, kw)[0]
            cases.append(((shape, arch, name, B), "decode", shape, arch,
                          toks, kw))
    for i, arch in enumerate(HANDOVER_ARCHS):
        cfg = configs(arch)[0]
        for B in ((4, 3) if shape == (2, 2) else (4,)):
            toks = torch.tensor(np.random.default_rng(20 + i).integers(
                0, cfg.vocab_size, (B, HANDOVER_SEQ)), dtype=torch.int32)
            cases.append(((shape, arch, "handover", B), "handover", shape,
                          arch, toks, handover_kw(cfg, shape)))
    if shape in ((1, 2), (1, 4), (2, 2)):
        cases += [((shape, a, "dryrun", s), "dryrun", shape, None, None,
                   dict(arch=a, shape=s)) for a, s in DRYRUN_CASES]
    return cases


_SPAWNED = {}


def spawned(world, tmp_path_factory):
    """Every rank's results of the cases of the meshes of ``world`` ranks,
    from one spawn."""
    if world not in _SPAWNED:
        cases = [c for shape in MESH_SHAPES if shape[0] * shape[1] == world
                 for c in mesh_cases(shape)]
        models = {arch: (model(arch)[0], model(arch)[2])
                  for arch in {c[3] for c in cases if c[3]}}
        _SPAWNED[world] = (cases, spawn(
            tpd_rank_body, world, tmp_path_factory.mktemp(f"tpd{world}"),
            models, cases))
    return _SPAWNED[world]


@pytest.mark.parametrize("shape", MESH_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_gloo_ranks_match_the_reference_decode(tmp_path_factory, shape,
                                               arch):
    """Each decode case of ``arch`` on ``shape``'s ranks: every rank's
    logits at every step and gathered cache within rtol = atol = 2e-4 of
    the reference's serve step and of the port's one-process step, its
    greedy ids the one-process ids wherever the top-2 margin is above the
    tolerance, the ranks bit for bit alike, each block the shape of its
    ``cache_pspecs`` spec, the collectives of every step those the layout
    implies, no kernel launched."""
    cases, ranks = spawned(shape[0] * shape[1], tmp_path_factory)
    mine = [c for c in cases if c[1] == "decode" and c[2] == shape
            and c[3] == arch]
    assert mine
    for key, _, _, _, _, kw in mine:
        cfg = model(arch)[0]
        B = key[3]
        toks, tlog, tcache, jlog, jcache = decodes(arch, B, kw)
        quant = kw.get("quant", False)
        want = want_counts(cfg, shape, B, kw)
        order, ms = layer_specs(cfg, shape, B, kw)
        for r, res in enumerate(ranks):
            logits, cache, counts, blocks, wholes, launches = res[key]
            np.testing.assert_allclose(logits.numpy(), jlog,
                                       err_msg=str(key), **F32)
            np.testing.assert_allclose(logits.numpy(), tlog.numpy(),
                                       err_msg=str(key), **F32)
            _cache_close(cache, jcache, quant, **F32)
            _cache_close(cache, tcache, quant, **F32)
            assert all(c == want for c in counts), (key, r, counts[0], want)
            assert not any(launches)
            specs = dict((k, s) for k, s in sharding.iter_leaves(
                sharding.cache_pspecs(cfg, treg.cache_specs(
                    cfg, B, kw["max_seq"], torch.float32,
                    quant=quant, **_opts(kw)), ms)))
            for path, got in blocks.items():
                assert got == sharding.block_shape(
                    wholes[path], specs[tuple(path.split("/"))], ms), path
            prompt = toks.shape[1] - GREEDY
            top2 = torch.topk(tlog[prompt - 1:-1], 2, -1).values
            sure = (top2[..., 0] - top2[..., 1]) > 2 * (
                F32["atol"] + F32["rtol"] * top2[..., 0].abs())
            ids = torch.argmax(logits[prompt - 1:-1], -1)
            assert torch.equal(ids[sure], toks[:, prompt:].T[sure])
            if r:
                assert torch.equal(logits, ranks[0][key][0])
                g, g0 = flat(cache), flat(ranks[0][key][1])
                assert all(np.array_equal(g[k], g0[k]) for k in g)


def test_gloo_ranks_cover_every_layout(tmp_path_factory):
    """The gloo cases between them keep K/V by kv heads, head dim, key
    sequence and whole, quantised, ring and long mode, and the batch
    split over "data" and whole."""
    seen, opts, batches = set(), set(), set()
    for shape in MESH_SHAPES:
        for key, kind, _, arch, _, kw in mesh_cases(shape):
            if kind != "decode":
                continue
            cfg = model(arch)[0]
            seen |= layouts_seen(cfg, shape, key[3], kw)
            opts |= {k for k in ("ring", "quant", "long_mode") if kw.get(k)}
            if shape[0] > 1:
                batches.add(key[3] % shape[0] == 0)
    assert seen == {"kv", "hd", "seq", "whole"}, seen
    assert opts == {"ring", "quant", "long_mode"}
    assert batches == {True, False}


@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_prefill_blocks_gather_to_its_whole_states(tmp_path_factory, shape):
    """The prefill's states as this rank's blocks (``cache_blocks=True``)
    in ``cache_pspecs``' layout of their own shapes, gathered, are its
    whole states bit for bit on the same ranks; a leaf the rank already
    holds as its block (kv heads or SSM heads over ``"model"``, the same
    batch rows) is kept without a gather."""
    cases, ranks = spawned(shape[0] * shape[1], tmp_path_factory)
    mine = [c for c in cases if c[1] == "handover" and c[2] == shape]
    assert mine
    for key, _, _, arch, toks, kw in mine:
        cfg = model(arch)[0]
        B = toks.shape[0]
        ms = sharding.MeshShape(shape, ("data", "model"))
        states = treg.cache_specs(cfg, B, HANDOVER_SEQ, torch.float32)
        specs = dict(sharding.iter_leaves(sharding.cache_pspecs(cfg, states,
                                                                ms)))
        for res in ranks:
            gathered, whole, blocks, (c_blocks, c_whole) = res[key]
            g, w = flat(gathered), flat(whole)
            assert sorted(g) == sorted(k for k in w if w[k].dtype != object)
            assert all(np.array_equal(g[k], w[k]) for k in g), key
            for path, got in blocks.items():
                k = tuple(path.split("/"))
                assert got == sharding.block_shape(
                    dict(sharding.iter_leaves(states))[k].shape, specs[k],
                    ms)
            assert c_blocks["all_gather_dim"] <= c_whole["all_gather_dim"]
            if arch == "qwen2-7b-reduced" and shape == (1, 2):
                # every k/v leaf kept: none of the whole path's state gathers
                assert c_whole["all_gather_dim"] - c_blocks[
                    "all_gather_dim"] == len(blocks)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_dryrun_cache_bytes_are_the_allocated_blocks(tmp_path_factory,
                                                     shape):
    """For decode cases at full size (decode_32k; long_500k, B = 1, the
    key sequence over ("data", "model")), the cache bytes a rank that
    ``launch/dryrun.py::case_plan`` counts on this mesh equal the bytes
    of the blocks ``init_cache(mesh=)`` allocates on that rank (on
    ``meta``), on every rank, and are below the whole cache's."""
    cases, ranks = spawned(shape[0] * shape[1], tmp_path_factory)
    mine = [c for c in cases if c[1] == "dryrun" and c[2] == shape]
    assert len(mine) == len(DRYRUN_CASES)
    for key, *_ in mine:
        for res in ranks:
            counted, allocated = res[key]
            assert counted == allocated > 0, key
