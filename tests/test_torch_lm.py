"""The port's dense LM serving path against the reference, on the CPU.

Both packages get the same inputs, made with numpy from one seed; the
reduced qwen1.5-0.5b and gemma2-27b get the reference's parameters through
``bridge.params_from_jax``. The reference's Pallas flash kernel runs in
interpret mode, as its own tests run it. Tolerances: f32 results within
2e-4 (``tests/test_kernels.py``: sums in another order and, through the
layers, f32 rounding that compounds over a few matmuls), bf16 within 3e-2
(one bf16 rounding of the output and of the inputs' products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.engine.model_store import GlobalModelStore as JStore
from repro.core.serve import loop as jloop
from repro.distributed import strategies as jstrat
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.serve import ServingLoop
from repro_torch.distributed import make_prefill_step
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.optim import tree_map
from test_torch_parity_helpers import assert_trees_close

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
ARCH_NAMES = ["qwen1.5-0.5b-reduced", "gemma2-27b-reduced"]


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()
                                          if isinstance(got, torch.Tensor)
                                          else got, np.float32),
                               np.asarray(want, np.float32), **tol)


_MODELS = {}


def model(name):
    """(port cfg, reference cfg, port params, reference params), built once."""
    if name not in _MODELS:
        jcfg = jget_arch(name)
        jp = jax.jit(lambda key: jreg.init(key, jcfg))(jax.random.PRNGKey(0))
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _MODELS[name] = (get_arch(name), jcfg, tp, jp)
    return _MODELS[name]


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_rope_softcap_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    scale = rng.normal(size=32).astype(np.float32)
    bias = rng.normal(size=32).astype(np.float32)
    _close(tlayers.rmsnorm_apply({"scale": _t(scale)}, _t(x)),
           jlayers.rmsnorm_apply({"scale": scale}, jnp.asarray(x)), **F32)
    p = {"scale": scale, "bias": bias}
    _close(tlayers.layernorm_apply({k: _t(v) for k, v in p.items()}, _t(x)),
           jlayers.layernorm_apply(p, jnp.asarray(x)), **F32)
    _close(tlayers.softcap(_t(x), 2.0), jlayers.softcap(jnp.asarray(x), 2.0),
           **F32)
    assert tlayers.softcap(_t(x), None) is not None
    h = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) + 5, (2, 7))
    _close(tlayers.apply_rope(_t(h), _t(pos), 1e6),
           jlayers.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e6), **F32)
    _close(tlayers.sinusoidal_positions(9, 16),
           jlayers.sinusoidal_positions(9, 16), **F32)
    emb = rng.normal(size=(11, 32)).astype(np.float32)
    _close(tlayers.embedding_attend({"embedding": _t(emb)}, _t(x)),
           jlayers.embedding_attend({"embedding": emb}, jnp.asarray(x)), **F32)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_reference(mlp_type):
    p = jax.tree.map(np.asarray, jlayers.mlp_init(
        jax.random.PRNGKey(1), 32, 64, mlp_type))
    x = np.random.default_rng(1).normal(size=(2, 3, 32)).astype(np.float32)
    _close(tlayers.mlp_apply(bridge.params_from_jax(p, device="cpu"), _t(x),
                             mlp_type),
           jlayers.mlp_apply(p, jnp.asarray(x), mlp_type), **F32)


# ---------------------------------------------------------------------------
# flash attention: the plain version and the model-layout adapter
# ---------------------------------------------------------------------------

VARIANTS = {"causal": dict(causal=True),
            "window": dict(causal=True, window=64),
            "softcap": dict(causal=True, softcap=20.0),
            "full": dict(causal=False)}


def _qkv(B, H, KV, Sq, Sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, H, Sq, hd)) * 0.3).astype(np.float32),
            (rng.normal(size=(B, KV, Sk, hd)) * 0.3).astype(np.float32),
            rng.normal(size=(B, KV, Sk, hd)).astype(np.float32))


@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 2, 2, 128, 128),      # MHA
    (2, 4, 2, 256, 64),       # GQA
    (1, 8, 1, 384, 128),      # MQA-ish, odd-length grid
])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ref_matches_pallas_kernel(B, H, KV, S, hd, variant,
                                                   dtype):
    q, k, v = _qkv(B, H, KV, S, S, hd)
    kw = VARIANTS[variant]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jfa.flash_attention(*(jnp.asarray(a).astype(jd)
                                 for a in (q, k, v)), interpret=True, **kw)
    got = tref.flash_attention_ref(*(_t(a, td) for a in (q, k, v)), **kw)
    assert got.dtype == td and got.shape == (B, H, S, hd)
    _close(got, np.asarray(want.astype(jnp.float32)),
           **(F32 if dtype == "float32" else BF16))


def test_flash_attention_ref_takes_any_sq_sk():
    """Sq = 1 against Sk = 257 (positions from 0: key 0 only under the
    causal mask), and a ragged 100 x 100 with a window: against the
    reference's plain version (its kernel needs tile multiples)."""
    for (Sq, Sk, kw) in [(1, 257, dict(causal=True)),
                         (1, 257, dict(causal=False)),
                         (100, 100, dict(causal=True, window=7,
                                         softcap=5.0))]:
        q, k, v = _qkv(2, 4, 2, Sq, Sk, 32, seed=Sq)
        _close(tref.flash_attention_ref(_t(q), _t(k), _t(v), **kw),
               jref.flash_attention_ref(q, k, v, **kw), **F32)


@pytest.mark.parametrize("kw", [dict(), dict(window=16),
                                dict(softcap=20.0)],
                         ids=["causal", "window", "softcap"])
def test_ops_flash_attention_and_grad_match_reference(kw):
    """Model layout (B, S, H, hd), GQA, with gradients against ``jax.grad``
    of the reference's custom-VJP ``ops.flash_attention``."""
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 48, 4, 2, 16
    q = (rng.normal(size=(B, S, H, hd)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(B, S, KV, hd)) * 0.5).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    w = rng.normal(size=(B, S, H, hd)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, causal=True, **kw) * w)

    jout = jax.jit(lambda q, k, v: jops.flash_attention(
        q, k, v, causal=True, **kw))(*map(jnp.asarray, (q, k, v)))
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, causal=True, **kw)
    assert out.shape == (B, S, H, hd)
    _close(out, jout, **F32)
    (out * _t(w)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, **F32)


# ---------------------------------------------------------------------------
# attention layer
# ---------------------------------------------------------------------------

def _attn_setup(name, S, seed=0):
    tcfg, jcfg, tp, jp = model(name)
    lp = jax.tree.map(lambda a: np.asarray(a)[0], jp["stack"]["b0"]["attn"])
    x = np.random.default_rng(seed).normal(
        size=(2, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    return (tcfg, jcfg, bridge.params_from_jax(lp, device="cpu"), lp, x, pos)


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("window", [None, 16])
def test_attention_matches_reference(name, use_kernel, window):
    tcfg, jcfg, tp, jp, x, pos = _attn_setup(name, 64)
    jout, (jk, jv) = jax.jit(lambda p, x, pos: jattn.attention(
        p, jcfg, x, pos, window=window, use_kernel=use_kernel))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    out, (k, v) = tattn.attention(tp, tcfg, _t(x), _t(pos), window=window,
                                  use_kernel=use_kernel)
    _close(out, jout, **F32)
    _close(k, jk, **F32)
    _close(v, jv, **F32)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_query_chunked_attention_matches_reference(name, monkeypatch):
    """The plain path's query-chunked branch, at threshold 64 / chunk 32 in
    both packages; with gradients (each chunk recomputed in backward)."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "QUERY_CHUNK_THRESHOLD", 64)
        monkeypatch.setattr(mod, "QUERY_CHUNK", 32)
    tcfg, jcfg, tp, jp, x, pos = _attn_setup(name, 128, seed=1)
    window = 48

    def jf(x):
        return jattn.attention(jp, jcfg, x, jnp.asarray(pos),
                               window=window)[0]

    jout, jgx = jax.jit(jax.value_and_grad(
        lambda x: jnp.sum(jf(x) ** 2)))(jnp.asarray(x))
    jout = jax.jit(jf)(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    out = tattn.attention(tp, tcfg, tx, _t(pos), window=window)[0]
    _close(out, jout, **F32)
    (out ** 2).sum().backward()
    _close(tx.grad, jgx, **F32)
    # the chunked branch agrees with the unchunked one
    monkeypatch.setattr(tattn, "QUERY_CHUNK_THRESHOLD", 4096)
    with torch.no_grad():
        _close(tattn.attention(tp, tcfg, _t(x), _t(pos), window=window)[0],
               jout, **F32)


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_lm_matches_reference(name, use_kernel):
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 96)
    jlog, _ = jax.jit(lambda p, t: jtf.forward_lm(
        p, jcfg, t, use_kernel=use_kernel))(jp, jnp.asarray(toks))
    with torch.no_grad():
        log, aux = ttf.forward_lm(tp, tcfg, _t(toks), use_kernel=use_kernel)
    assert log.shape == (2, 96, tcfg.vocab_size) and float(aux) == 0.0
    _close(log, jlog, **F32)


def _grads(params, fn):
    """(loss, gradient tree) of ``fn`` at a copy of ``params``."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = fn(p)
    loss.backward()
    return loss, tree_map(lambda t: t.grad, p)


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("chunked", [False, True])
def test_loss_lm_and_grads_match_reference(name, chunked, monkeypatch):
    """Plain and chunked cross-entropy (threshold 0, chunk 16 in both
    packages: 63 targets pad to 64), with ``remat`` on, and the gradients
    of every parameter."""
    if chunked:
        for mod in (jtf, ttf):
            monkeypatch.setattr(mod, "LOSS_CHUNK_MIN_ELEMENTS", 0)
            monkeypatch.setattr(mod, "LOSS_CHUNK", 16)
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 64, seed=2)
    mask = (np.random.default_rng(2).random((2, 64)) > 0.2).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_lm(p, jcfg, jbatch, remat=True),
        has_aux=True))(jp)
    tbatch = {"tokens": _t(toks), "mask": _t(mask)}
    fn = treg.loss_fn(tcfg, remat=True)
    loss, grads = _grads(tp, lambda p: fn(p, tbatch)[0])
    _close(loss, jl, **F32)
    assert_trees_close(grads, jax.tree.map(np.asarray, jg), **F32)


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_step_matches_reference(name, use_kernel):
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 80, seed=3)
    jlog, jst = jax.jit(jstrat.make_prefill_step(
        jcfg, use_kernel=use_kernel))(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        log, st = make_prefill_step(tcfg, use_kernel=use_kernel)(
            tp, {"tokens": _t(toks)})
    assert log.shape == (2, tcfg.vocab_size)
    _close(log, jlog, **F32)
    assert st["tail"] == {} and jst["tail"] == {}
    assert_trees_close(st["stack"], jax.tree.map(np.asarray, jst["stack"]),
                       **F32)


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("cache", ["f32", "ring", "quant"])
def test_decode_step_matches_reference(name, cache):
    """Teacher-forced decode of 80 tokens (past gemma2's window of 64, so a
    ring cache wraps) into a 96-slot cache: logits at every step and the
    caches at the end. The port writes its cache in place."""
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 80, seed=4)
    kw = dict(ring=cache == "ring", quant=cache == "quant")
    jc = jreg.init_cache(jp, jcfg, 2, 96, **kw)
    tc = treg.init_cache(tp, tcfg, 2, 96, **kw)
    assert_trees_close(tc, jax.tree.map(np.asarray, jc), rtol=0, atol=0)
    jstep = jax.jit(jreg.decode_fn(jcfg, ring=kw["ring"]))
    tstep = treg.decode_fn(tcfg, ring=kw["ring"])
    for pos in range(toks.shape[1]):
        jlog, jc = jstep(jp, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        with torch.no_grad():
            log, same = tstep(tp, tc, _t(toks[:, pos]), pos)
        assert same is tc
        _close(log, jlog, **F32)
    jc = jax.tree.map(np.asarray, jc)
    if cache == "quant":
        # int8 planes may round one step apart where a value lies on a
        # rounding boundary: compare the dequantised caches
        for tree in (tc, jc):
            for blk in tree["stack"].values():
                for n in ("k", "v"):
                    blk[n] = (np.asarray(blk[n], np.float32)
                              * np.asarray(blk[n + "s"])
                              + np.asarray(blk[n + "r"], np.float32)
                              * np.asarray(blk[n + "rs"]))
                    for s in ("s", "r", "rs"):
                        del blk[n + s]
    assert_trees_close(tc, jc, **F32)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_serving_loop_matches_reference(name):
    """Traffic ids exactly equal, greedy ids equal, over two ticks."""
    tcfg, jcfg, tp, jp = model(name)
    jl = jloop.ServingLoop(JStore(params=jp), jcfg, batch=3, prompt_len=5,
                           tokens=6, seed=7)
    tl = ServingLoop(GlobalModelStore(params=tp), tcfg, batch=3,
                     prompt_len=5, tokens=6, seed=7)
    for tick in range(2):
        prompts = tl._traffic(tick)
        np.testing.assert_array_equal(prompts, jl._traffic(tick))
        jids, _ = jl.decode(prompts)
        ids, dt = tl.decode(prompts)
        assert dt > 0
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    from repro_torch.core import History
    h = History()
    tl.store.advance()
    assert tl.tick(3, h) > 0
    assert h.serve_rounds == [3] and h.serve_staleness == [1]
    assert tl.served_version == 1


@pytest.mark.parametrize("ref_store", ["f32", "q8"])
def test_model_store_snapshot_matches_reference(ref_store):
    """``snapshot`` hands out the tree clients hold: through the downlink
    codec's ``load_tree`` when one is set (a q8 store dequantises), else
    ``params``; ``advance`` bumps the version."""
    from repro.core.engine import transport as jt
    from repro_torch.core.engine import transport as tt
    tcfg, jcfg, tp, jp = model(ARCH_NAMES[0])
    stores = []
    for mod, Store, params in ((tt, GlobalModelStore, tp), (jt, JStore, jp)):
        store = Store(params=params,
                      downlink=mod.get_downlink("int8", ref_store=ref_store))
        store.downlink_state = store.downlink.init_state(params)
        stores.append(store)
    (tv, tsnap), (jv, jsnap) = (st.snapshot() for st in stores)
    assert tv == jv == 0
    assert_trees_close(tsnap, jax.tree.map(np.asarray, jsnap), **F32)
    assert stores[0].advance(2) == 2 and stores[0].snapshot()[0] == 2
    version, tree = GlobalModelStore(params=tp).snapshot()
    assert version == 0 and tree is tp


def test_serve_launcher_runs_reduced_config_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "gemma2-27b", "--batch", "2", "--prompt-len", "3",
                "--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "gemma2-27b-reduced (dense): batch=2, 4 tokens/seq" in out
    assert "ids[0] = [" in out


def test_param_count_exact_at_full_width():
    assert set(ARCHS) == {"qwen1.5-0.5b", "qwen2-7b", "gemma2-27b",
                          "nemotron-4-340b", "mixtral-8x22b",
                          "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                          "zamba2-7b"}
    for name, cfg in ARCHS.items():
        assert treg.param_count(cfg) == jreg.param_count(jget_arch(name))
        assert treg.active_param_count(cfg) == jreg.active_param_count(
            jget_arch(name))
        assert cfg.param_count() == treg.param_count(cfg)
    assert treg.param_count(ARCHS["qwen1.5-0.5b"]) == 463_987_712


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_reduced_configs_and_init_match_reference(name):
    """The reduced config equals the reference's field for field; the
    port's own init gives the reference's tree (keys, shapes) with its
    distributions (zero biases, unit norms, lecun kernels)."""
    tcfg, jcfg, tp, jp = model(name)
    import dataclasses
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    own = treg.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert_trees_close(
        jax.tree.map(lambda t: np.zeros(t.shape), own),
        jax.tree.map(lambda a: np.zeros(np.shape(a)), jp), rtol=0, atol=0)
    again = treg.init(0, tcfg, device="cpu")
    assert torch.equal(own["embed"]["embedding"], again["embed"]["embedding"])
    blk = own["stack"]["b0"]
    assert float(blk["ln1"]["scale"].min()) == 1.0
    if tcfg.qkv_bias:
        assert not blk["attn"]["wq"]["bias"].any()
    std = float(blk["mlp"]["up"]["kernel"].std())
    assert abs(std * tcfg.d_model ** 0.5 - 1.0) < 0.05
