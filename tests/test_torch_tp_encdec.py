"""The encoder-decoder on the ``"model"`` ranks (ROADMAP A15 (d)):
whisper's prefill, encoder run and decode on each rank's heads, d_ff block
and vocabulary block, its self and cross caches as blocks in
``cache_pspecs``' layout, against the reference on the CPU.

* Each module, in one process over simulated ranks (one thread a rank,
  collectives through a barrier; ``Sim``/``SimRank`` of
  ``tests/test_torch_tp_decode.py``) at m = 2, 3 and 4: the encoder
  (``encdec.encode``, one layer) on each rank's heads and d_ff block
  against the reference's; ``cross_attention_kv``'s block of each rank
  equal to its slice of the reference's cross (k, v), and
  ``cross_attention``'s partials summed against the reference's, over
  every cross-cache layout (kv heads, head dim, encoder sequence, encoder
  sequence over the batch axes and ``"model"``, whole), a rank's query
  heads off the group size among them; all within rtol = atol = 2e-4.
* A world of one rank, in this process: the prefill, ``init_cache(mesh=)``
  and the decode bit for bit the step without a mesh, no collective.
* Spawned gloo ranks (rank body ``tpe_rank_body`` in
  ``tests/test_torch_mesh_ranks.py``, no JAX; one spawn a world size) on
  (1, 2) (both caches by kv heads), (1, 3) with head_dim 24 (by head dim),
  (1, 3) with encoder_seq 12 and a 12-slot cache (by key sequence) and
  (2, 2) (a batch of 4 over "data", then 3, whole on each data rank): a
  prompt and 6 greedy tokens. Every rank's prefill logits, decode logits
  and gathered cache within rtol = atol = 2e-4 of the reference's jitted
  ``make_prefill_step`` and ``make_serve_step`` on ``init_cache(...,
  audio_embeds=)``, on the same weights (``bridge.params_from_jax``); the
  greedy ids the one-process ids wherever the top-2 margin is above the
  tolerance; the ranks bit for bit alike; each block the shape of
  ``block_shape(cache_pspecs)``; the collectives those the layout implies;
  no kernel launched.
* Refusals, by name: a mesh without ``"model"``, a cache not laid out on
  the step's mesh, a cross block that is not the kv heads a rank reads, a
  given block of the wrong shape.
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
from repro.models import encdec as jencdec
from repro.models import registry as jreg
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import (make_prefill_step, make_serve_step,
                                     sharding)
from repro_torch.kernels import collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import registry as treg
from repro_torch.optim import tree_map
from test_torch_mesh_ranks import spawn, tpe_rank_body
from test_torch_parity_helpers import flat
from test_torch_parity_helpers import one_torch_thread  # noqa: F401
from test_torch_tp_decode import (NoModel, SimRank, attn_cfgs, place_of,
                                  run_ranks, whole_of)

F32 = dict(rtol=2e-4, atol=2e-4)
WHISPER = "whisper-tiny-reduced"
PROMPT, GREEDY, MAX_SEQ = 5, 6, 12     # 12 divides among 2, 3 and 4 ranks
# (name, the config's replaced fields)
VARIANTS = {"base": {}, "hd24": dict(head_dim=24),
            "enc12": dict(encoder_seq=12)}
# (mesh, variant, batch): the cases of the spawned ranks
MESH_CASES = [((1, 2), "base", 4), ((1, 3), "hd24", 4), ((1, 3), "enc12", 4),
              ((2, 2), "base", 4), ((2, 2), "base", 3)]

_MODELS = {}


def model(variant):
    """(port cfg, reference cfg, port params, reference params) of reduced
    whisper-tiny with ``VARIANTS[variant]``: the reference's init from
    seed 0, carried over by ``bridge.params_from_jax``; built once."""
    if variant not in _MODELS:
        kw = VARIANTS[variant]
        jcfg = dataclasses.replace(jget_arch(WHISPER), **kw)
        jp = jax.jit(lambda key: jreg.init(key, jcfg))(jax.random.PRNGKey(0))
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _MODELS[variant] = (dataclasses.replace(get_arch(WHISPER), **kw),
                            jcfg, tp, jp)
    return _MODELS[variant]


def audio_of(cfg, B, seed):
    return (np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# simulated ranks: the encoder, cross attention and its cache blocks
# ---------------------------------------------------------------------------

class EncRank(SimRank):
    """``SimRank`` with the compute blocks ``encdec.encode`` reads."""

    def blocks(self, cfg, seq_len):
        return sharding.compute_blocks(cfg, seq_len, self.size, self.rank)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_encoder_layer_on_ranks_matches_the_reference(m):
    """One encoder layer (``encdec.encode`` over the first layer of the
    stack) on each of ``m`` ranks (query heads 2, 2 / 2, 1, 1 / 1 each;
    d_ff 256 / 171, 171, 170 / 128 each): its attention and MLP partials
    summed over the ranks give the reference's ``encode`` on every rank."""
    tcfg, jcfg, tp, jp = model("base")
    tp1 = {**tp, "enc_stack": tree_map(lambda t: t[:1], tp["enc_stack"])}
    jp1 = {**jp, "enc_stack": jax.tree.map(lambda a: a[:1],
                                           jp["enc_stack"])}
    audio = audio_of(tcfg, 2, 1)
    want = np.asarray(jax.jit(lambda p, a: jencdec.encode(p, jcfg, a))(
        jp1, jnp.asarray(audio)))

    def rank(r, sim):
        with torch.no_grad():
            return tencdec.encode(tp1, tcfg, torch.tensor(audio),
                                  EncRank(sim, r, list(range(m))))

    for got in run_ranks(m, rank):
        np.testing.assert_allclose(got.numpy(), want, **F32)


# (layout, H, KV, hd, "model" ranks, "data" ranks, encoder sequence L)
CROSS = [
    ("kv", 8, 4, 16, 2, 1, 16),
    ("kv", 8, 4, 16, 4, 1, 16),
    ("hd", 8, 4, 24, 3, 1, 16),      # query heads 3, 3, 2: off the group
    ("seq", 8, 4, 16, 3, 1, 12),
    ("seq", 6, 2, 16, 4, 1, 24),
    ("seq_batch", 8, 4, 16, 2, 2, 16),
    ("whole", 8, 4, 16, 3, 1, 16),
]


@pytest.mark.parametrize("case", CROSS, ids=lambda c: "-".join(
    str(v) for v in c))
def test_cross_attention_over_every_layout_matches_the_reference(case):
    """Each rank's cross (k, v) block from ``cross_attention_kv(place=)``
    (its columns of ``wk``/``wv``, or its rows of the encoder's output,
    no collective) put together is the reference's ``cross_attention_kv``,
    each block of the shape its layout gives; ``cross_attention(heads=,
    place=)`` over those blocks, summed over a ``"model"`` group, is the
    reference's ``cross_attention``."""
    layout, H, KV, hd, m, data, L = case
    tcfg, jcfg, tp, jp = attn_cfgs(H, KV, hd)
    n, B, Sq = m * data, 2, 3
    rng = np.random.default_rng(11)
    enc = rng.normal(size=(B, L, tcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(B, Sq, tcfg.d_model)).astype(np.float32)
    jk, jv = jattn.cross_attention_kv(jp, jcfg, jnp.asarray(enc))
    jout = np.asarray(jattn.cross_attention(jp, jcfg, jnp.asarray(x),
                                            (jk, jv)))
    kv_sizes = tuple(hi - lo for lo, hi in (
        tattn.head_block(H, KV, m, j).own for j in range(m)))

    def rank(r, sim):
        heads = tattn.head_block(H, KV, m, r % m)
        place, blk = place_of(layout, r, m, n, L, KV, hd, heads, kv_sizes,
                              sim)
        k, v = tattn.cross_attention_kv(tp, tcfg, torch.tensor(enc), place)
        assert tuple(k.shape) == tuple(v.shape) == (B,) + blk
        out = tattn.cross_attention(tp, tcfg, torch.tensor(x), (k, v),
                                    heads=heads, place=place)
        return k, v, out

    res = run_ranks(n, rank)
    for name, want in (("k", jk), ("v", jv)):
        i = "kv".index(name)
        got = whole_of(layout, [r[i] for r in res], m, n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **F32)
    for d in range(data):
        got = sum(res[d * m + j][2] for j in range(m))
        np.testing.assert_allclose(got.numpy(), jout, **F32)


def test_cross_attention_refuses_blocks_it_does_not_read():
    """A cross block kept by kv heads that are not the kv heads the rank's
    query heads read is refused by name (``_read``); a given block of
    another shape than its layout's is refused by ``CacheLayout.init``."""
    tcfg, _, tp, _ = attn_cfgs(8, 4, 16)
    heads = tattn.head_block(8, 4, 2, 1)                   # reads kv 2, 3
    kv = torch.zeros((2, 16, 2, 16))
    with pytest.raises(ValueError, match="its query heads read"):
        tattn.cross_attention(tp, tcfg, torch.zeros((2, 1, tcfg.d_model)),
                              (kv, kv), heads=heads,
                              place=tattn.KVPlace(16, 2, (0, 2)))
    cfg = get_arch(WHISPER)
    layout = sharding.CacheLayout(cfg, treg.cache_specs(cfg, 2, 4,
                                                        torch.float32), None)
    bad = torch.zeros((cfg.num_layers, 2, 3, cfg.num_kv_heads, cfg.head_dim))
    with pytest.raises(ValueError, match="cache leaf cross/xk"):
        layout.init("cpu", given={"cross": {"xk": bad, "xv": bad}})


# ---------------------------------------------------------------------------
# a world of one rank: bit for bit the steps without a mesh
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


def _zero_counts():
    for kind in collectives.counts:
        collectives.counts[kind] = 0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_one_rank_is_the_encdec_without_a_mesh_bit_for_bit(mesh1, variant):
    """On a world of one rank the prefill's logits, ``init_cache(mesh=)``
    (a ``CacheBlocks`` of whole blocks) and every decode step's logits
    and the cache after them are the steps without a mesh bit for bit,
    and no collective runs."""
    tcfg, _, tp, _ = model(variant)
    B, T = 3, 8
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (B, T)), dtype=torch.int32)
    audio = torch.tensor(audio_of(tcfg, B, 3))
    batch = {"tokens": toks, "audio_embeds": audio}
    _zero_counts()
    got = make_prefill_step(tcfg, mesh=mesh1)(tp, batch)
    with torch.no_grad():
        want = make_prefill_step(tcfg)(tp, batch)
    assert torch.equal(got, want)
    with torch.no_grad():
        whole = treg.init_cache(tp, tcfg, B, MAX_SEQ, audio_embeds=audio)
    blocks = treg.init_cache(tp, tcfg, B, MAX_SEQ, audio_embeds=audio,
                             mesh=mesh1)
    assert isinstance(blocks, sharding.CacheBlocks)
    one, ranked = make_serve_step(tcfg), make_serve_step(tcfg, mesh=mesh1)
    for pos in range(T):
        with torch.no_grad():
            want, _ = one(tp, whole, toks[:, pos], pos)
        got, same = ranked(tp, blocks, toks[:, pos], pos)
        assert same is blocks and torch.equal(got, want), pos
    assert not any(collectives.counts.values())
    g, w = flat(dict(blocks)), flat(whole)
    assert sorted(g) == sorted(w)
    assert all(np.array_equal(g[k], w[k]) for k in w)


def test_serve_step_refuses_what_it_cannot_place(mesh1):
    """The encoder-decoder's step refuses, by name, a mesh without
    ``"model"`` and a cache that is not this rank's blocks on its mesh."""
    tcfg, _, tp, _ = model("base")
    with pytest.raises(ValueError, match="no 'model' axis"):
        make_serve_step(tcfg, mesh=NoModel())
    audio = torch.tensor(audio_of(tcfg, 2, 0))
    tok = torch.zeros((2,), dtype=torch.int32)
    step = make_serve_step(tcfg, mesh=mesh1)
    with pytest.raises(ValueError, match="init_cache"):
        step(tp, treg.init_cache(tp, tcfg, 2, 4, audio_embeds=audio), tok, 0)


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------

_DECODES = {}


def decodes(variant, B):
    """(tokens (B, T): a prompt and the port's one-process greedy ids,
    its audio, the one-process logits (T, B, V), the reference's prefill
    logits, decode logits (T, B, V) and final cache), built once a
    case."""
    key = (variant, B)
    if key in _DECODES:
        return _DECODES[key]
    tcfg, jcfg, tp, jp = model(variant)
    seed = sorted({(v, b) for _, v, b in MESH_CASES}).index(key)
    rng = np.random.default_rng(seed)
    audio = audio_of(tcfg, B, seed + 10)
    toks = list(torch.tensor(rng.integers(0, tcfg.vocab_size, (B, PROMPT)),
                             dtype=torch.int32).T)
    step = make_serve_step(tcfg)
    logits = []
    with torch.no_grad():
        cache = treg.init_cache(tp, tcfg, B, MAX_SEQ,
                                audio_embeds=torch.tensor(audio))
        for pos in range(PROMPT + GREEDY):
            got, cache = step(tp, cache, toks[pos], pos)
            logits.append(got)
            if pos >= PROMPT - 1 and len(toks) < PROMPT + GREEDY:
                toks.append(torch.argmax(got, -1).to(torch.int32))
    toks = torch.stack(toks, 1)
    jprefill = np.asarray(jax.jit(jstrat.make_prefill_step(jcfg))(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT].numpy()),
             "audio_embeds": jnp.asarray(audio)}))
    jc = jreg.init_cache(jp, jcfg, B, MAX_SEQ,
                         audio_embeds=jnp.asarray(audio))
    jstep = jax.jit(jstrat.make_serve_step(jcfg))
    jlog = []
    for pos in range(toks.shape[1]):
        got, jc = jstep(jp, jc, jnp.asarray(toks[:, pos].numpy()),
                        jnp.int32(pos))
        jlog.append(np.asarray(got))
    _DECODES[key] = (toks, audio, torch.stack(logits), jprefill,
                     np.stack(jlog), jax.tree.map(np.asarray, jc))
    return _DECODES[key]


_SPAWNED = {}


def spawned(world, tmp_path_factory):
    """Every rank's results of the cases of ``world`` ranks, one spawn."""
    if world not in _SPAWNED:
        cases, models = [], {}
        for shape, variant, B in MESH_CASES:
            if shape[0] * shape[1] != world:
                continue
            tcfg, _, tp, _ = model(variant)
            models[variant] = (tcfg, tp)
            toks, audio = decodes(variant, B)[:2]
            cases.append(((shape, variant, B), shape, variant, toks,
                          torch.tensor(audio), PROMPT, MAX_SEQ))
        _SPAWNED[world] = spawn(tpe_rank_body, world,
                                tmp_path_factory.mktemp(f"tpe{world}"),
                                models, cases)
    return _SPAWNED[world]


def want_counts(cfg, shape, B):
    """Each rank's collectives by kind in the prefill, in ``init_cache``
    and in one decode step, from the layout: two all-reduces an encoder
    layer (attention's and the MLP's partials) and three a decoder layer
    (self and cross attention's, the MLP's); a decode step's new slot's
    kv heads gathered unless the self cache keeps kv heads over
    ``"model"``, and the blocks of each cache gathered at use where the
    key sequence or head dim is split (one an axis of more than one
    rank); the readout's vocabulary blocks and batch rows. ``init_cache``
    computes its cross blocks with no collective."""
    names = ("data", "model")
    ms = sharding.MeshShape(shape, names)
    m = shape[-1]
    big = lambda axes: sum(ms.shape.get(a, 1) > 1 for a in axes)
    ba = sharding.serve_batch_axes(ms)
    batch = big(ba) if B % sharding.entry_size(ms, ba) == 0 else 0
    specs = sharding.cache_pspecs(cfg, treg.cache_specs(
        cfg, B, MAX_SEQ, torch.float32), ms)
    zero = dict.fromkeys(collectives.counts, 0)
    enc = {**zero, "all_reduce": 2 * cfg.encoder_layers * (m > 1)}
    readout = (m > 1) + batch
    prefill = {**enc, "all_reduce": enc["all_reduce"]
               + 3 * cfg.num_layers * (m > 1), "all_gather_dim": readout}
    step = {**zero, "all_reduce": 3 * cfg.num_layers * (m > 1),
            "all_gather_dim": readout}
    for spec, writes in ((specs["k"], True), (specs["cross"]["xk"], False)):
        s_e, kv_e, hd_e = spec[-3:]
        if kv_e == "model":
            continue
        step["all_gather_dim"] += cfg.num_layers * writes * (m > 1)
        entry = hd_e if hd_e is not None else s_e
        step["all_gather"] += cfg.num_layers * big(sharding._names(entry))
    return prefill, enc, step, specs


def layout_name(spec):
    s_e, kv_e, hd_e = spec[-3:]
    return ("kv" if kv_e == "model" else "hd" if hd_e == "model"
            else "seq_batch" if isinstance(s_e, tuple)
            else "seq" if s_e else "whole")


@pytest.mark.parametrize("case", MESH_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_gloo_ranks_match_the_reference(tmp_path_factory, case):
    """The case's prefill, ``init_cache(mesh=)`` and decode on every rank:
    within rtol = atol = 2e-4 of the reference's jitted steps (logits,
    cache) and of the port's one-process decode; greedy ids the
    one-process ids wherever its top-2 margin is above the tolerance; the
    ranks bit for bit alike; each block of both caches the shape of its
    ``cache_pspecs`` spec, the layout the case names; the collectives of
    the prefill, ``init_cache`` and every step those the layout implies;
    no kernel launched."""
    shape, variant, B = case
    ranks = spawned(shape[0] * shape[1], tmp_path_factory)
    key = (shape, variant, B)
    tcfg = model(variant)[0]
    toks, _, tlog, jprefill, jlog, jcache = decodes(variant, B)
    prefill, enc, step, specs = want_counts(tcfg, shape, B)
    ms = sharding.MeshShape(shape, ("data", "model"))
    want_layout = {"base": "kv", "hd24": "hd", "enc12": "seq"}[variant]
    assert layout_name(specs["k"]) == layout_name(
        specs["cross"]["xk"]) == want_layout
    flat_specs = dict(sharding.iter_leaves(specs))
    for r, res in enumerate(ranks):
        pl, logits, cache, counts, blocks, wholes, launches = res[key]
        np.testing.assert_allclose(pl.numpy(), jprefill, err_msg=str(key),
                                   **F32)
        np.testing.assert_allclose(logits.numpy(), jlog, err_msg=str(key),
                                   **F32)
        np.testing.assert_allclose(logits.numpy(), tlog.numpy(), **F32)
        g, w = flat(cache), flat(jcache)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **F32)
        assert counts[0] == prefill and counts[1] == enc, (r, counts[:2])
        assert all(c == step for c in counts[2:]), (r, counts[2], step)
        assert launches == 0
        for path, got in blocks.items():
            assert got == sharding.block_shape(
                wholes[path], flat_specs[tuple(path.split("/"))], ms), path
        top2 = torch.topk(tlog[PROMPT - 1:-1], 2, -1).values
        sure = (top2[..., 0] - top2[..., 1]) > 2 * (
            F32["atol"] + F32["rtol"] * top2[..., 0].abs())
        ids = torch.argmax(logits[PROMPT - 1:-1], -1)
        assert torch.equal(ids[sure], toks[:, PROMPT:].T[sure])
        if r:
            assert torch.equal(pl, ranks[0][key][0])
            assert torch.equal(logits, ranks[0][key][1])
            g0 = flat(ranks[0][key][2])
            assert all(np.array_equal(g[k], g0[k]) for k in g)


def test_a_rank_holds_half_the_caches_at_two_ranks():
    """At (1, 2) both caches keep kv heads (2 of 4 a rank): the bytes a
    rank's blocks take (``CacheLayout.block_bytes``, what
    ``init_cache(mesh=)`` allocates) are half the whole cache's, the cross
    cache's among them."""
    cfg = get_arch(WHISPER)
    ms = sharding.MeshShape((1, 2), ("data", "model"))
    shapes = treg.cache_specs(cfg, 4, MAX_SEQ, torch.float32)
    specs = sharding.cache_pspecs(cfg, shapes, ms)
    whole = sum(t.numel() * 4 for _, t in sharding.iter_leaves(shapes))
    assert 2 * sharding.block_bytes(shapes, specs, ms) == whole
    assert 2 * sharding.block_bytes(shapes["cross"], specs["cross"],
                                    ms) == sum(
        t.numel() * 4 for _, t in sharding.iter_leaves(shapes["cross"]))
