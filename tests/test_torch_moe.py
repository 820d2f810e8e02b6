"""The port's MoE serving path against the reference, on the CPU.

Both packages get the same inputs, made with numpy from one seed; the
reduced phi3.5-moe-42b-a6.6b and mixtral-8x22b (whose 64-token window the
96-token sequences pass) get the reference's parameters through
``bridge.params_from_jax``. The reference's Pallas grouped matmul runs in
interpret mode, as its own tests run it. Tolerances: f32 within 2e-4
(``tests/test_kernels.py``: sums in another order, compounding over a few
matmuls), bf16 within 3e-2 (one bf16 rounding of each product's output).
Routing ids are compared exactly, after checking that no top-k margin of
the inputs lies within the tolerance (a last-bit difference in the router
could flip such a choice); elsewhere a flip would show as an output far
outside the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.engine.model_store import GlobalModelStore as JStore
from repro.core.serve import loop as jloop
from repro.distributed import strategies as jstrat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.serve import ServingLoop
from repro_torch.distributed import make_prefill_step, make_serve_step
from repro_torch.kernels import moe_gmm as tmg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.optim import tree_map
from test_torch_parity_helpers import assert_trees_close
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=3e-2, atol=3e-2)
KERNEL = dict(rtol=2e-3, atol=2e-3)          # tests/test_moe.py:41-46
ARCH_NAMES = ["phi3.5-moe-42b-a6.6b-reduced", "mixtral-8x22b-reduced"]
GMM_SHAPES = [(4, 128, 256, 512), (8, 100, 512, 384), (2, 257, 320, 640)]


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


def with_capacity(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def layer_moe(name, cf=None):
    """One layer's MoE params and a normed-scale input of (2, 32, d)."""
    tcfg, jcfg, tp, jp = model(name)
    if cf is not None:
        tcfg, jcfg = with_capacity(tcfg, cf), with_capacity(jcfg, cf)
    lp = jax.tree.map(lambda a: np.asarray(a)[0], jp["stack"]["b0"]["moe"])
    x = (np.random.default_rng(1).normal(size=(2, 32, tcfg.d_model))
         .astype(np.float32))
    return tcfg, jcfg, bridge.params_from_jax(lp, device="cpu"), lp, x


def assert_margins_clear(probs, k, tol=1e-5):
    """The k-th and (k+1)-th router probabilities of every token lie more
    than ``tol`` apart, so a last-bit difference cannot flip a choice."""
    top = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    assert float((top[..., k - 1] - top[..., k]).min()) > tol


# ---------------------------------------------------------------------------
# the grouped matmul: plain version, wrapper and the expert FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,C,d,f", GMM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_ref_matches_pallas_kernel(E, C, d, f, dtype):
    rng = np.random.default_rng(E + C)
    x = (rng.normal(size=(E, C, d)) * 0.1).astype(np.float32)
    w = (rng.normal(size=(E, d, f)) * 0.05).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.gmm(jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd))
    tol = F32 if dtype == "float32" else BF16
    for fn in (tref.gmm_ref, tops.gmm):
        got = fn(_t(x, td), _t(w, td))
        assert got.dtype == td and got.shape == (E, C, f)
        _close(got, np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_matches_reference(mlp_type, dtype):
    """``ops.moe_gmm`` (f32 activation, cast before ``down``) and its plain
    version against the reference's, with the gradients of the wrapper's
    backward against ``jax.grad`` of the reference's plain version."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 64, 128)) * 0.3).astype(np.float32)
    gate, up = ((rng.normal(size=(4, 128, 256)) * 0.05).astype(np.float32)
                for _ in range(2))
    down = (rng.normal(size=(4, 256, 128)) * 0.05).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    args = (x, gate, up, down)
    want = jops.moe_gmm(*(jnp.asarray(a).astype(jd) for a in args),
                        mlp_type=mlp_type)
    want_ref = jref.moe_ffn_ref(*(jnp.asarray(a).astype(jd) for a in args),
                                mlp_type=mlp_type)
    tol = F32 if dtype == "float32" else BF16
    targs = [_t(a, td) for a in args]
    _close(tops.moe_gmm(*targs, mlp_type=mlp_type),
           np.asarray(want.astype(jnp.float32)), **tol)
    _close(tref.moe_ffn_ref(*targs, mlp_type=mlp_type),
           np.asarray(want_ref.astype(jnp.float32)), **tol)
    if dtype == "float32":
        wt = rng.normal(size=(4, 64, 128)).astype(np.float32)
        # the Pallas call has no JVP: the gradient is the plain version's
        jg = jax.grad(lambda *a: jnp.sum(jref.moe_ffn_ref(
            *a, mlp_type=mlp_type) * wt), argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, args))
        leaves = [t.clone().requires_grad_() for t in targs]
        (tops.moe_gmm(*leaves, mlp_type=mlp_type) * _t(wt)).sum().backward()
        for got, want_g in zip(leaves, jg):
            # gelu never reads gate: no gradient in torch, zeros in JAX
            g = got.grad if got.grad is not None else torch.zeros_like(got)
            _close(g, want_g, **F32)


def test_gmm_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4, 8))
    w = torch.zeros((2, 8, 16))
    with pytest.raises(TypeError):
        tmg.gmm(x, w.to(torch.bfloat16))           # mixed dtypes
    with pytest.raises(TypeError):
        tmg.gmm(x.double(), w.double())
    with pytest.raises(ValueError):
        tmg.gmm(x, w[:, :4])                       # d mismatch
    with pytest.raises(ValueError):
        tmg.gmm(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    before = tmg.launches
    assert tmg.gmm(x, w).shape == (2, 4, 16)
    assert tmg.launches == before                  # the CPU runs no kernel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_reference(dtype):
    """``_expert_ffn`` stays in x's dtype (einsums), unlike ``moe_gmm``."""
    tcfg, jcfg, tp, jp, _ = layer_moe(ARCH_NAMES[0])
    xe = (np.random.default_rng(2).normal(size=(4, 24, tcfg.d_model)) * 0.5
          ).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jmoe._expert_ffn(jax.tree.map(lambda a: jnp.asarray(a).astype(jd),
                                         jp), jcfg, jnp.asarray(xe).astype(jd))
    got = tmoe._expert_ffn(tree_map(lambda t: t.to(td), tp), tcfg,
                           _t(xe, td))
    assert got.dtype == td
    _close(got, np.asarray(want.astype(jnp.float32)),
           **(F32 if dtype == "float32" else BF16))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_route_matches_reference(name):
    tcfg, jcfg, tp, jp, x = layer_moe(name)
    xf = x.reshape(-1, tcfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"]["kernel"], -1)
    assert_margins_clear(probs, tcfg.moe.top_k)
    jw, jids, jaux = jmoe._route(jp, jcfg, jnp.asarray(xf))
    w, ids, aux = tmoe._route(tp, tcfg, _t(xf))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw, **F32)
    _close(aux, jaux, **F32)


@pytest.mark.parametrize("path,cf,use_kernel", [
    ("dense", None, False),
    ("dispatch", 8.0, False), ("dispatch", 8.0, True),      # nothing drops
    ("dispatch", 0.5, False), ("dispatch", 0.5, True),      # drops
], ids=["dense", "cf8", "cf8-kernel", "cf0.5", "cf0.5-kernel"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_moe_apply_matches_reference(name, path, cf, use_kernel):
    tcfg, jcfg, tp, jp, x = layer_moe(name, cf)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(
        p, jcfg, x, path=path, use_kernel=use_kernel))(jp, jnp.asarray(x))
    y, aux = tmoe.moe_apply(tp, tcfg, _t(x), path=path, use_kernel=use_kernel)
    assert y.shape == x.shape
    _close(y, jy, **(KERNEL if use_kernel else F32))
    _close(aux, jaux, **F32)
    if path == "dispatch":
        T = x.shape[0] * x.shape[1]
        assert tmoe.capacity(tcfg, T) == (256 if cf == 8.0 else 16)
        dense, _ = tmoe.moe_apply_dense(tp, tcfg, _t(x))
        same = torch.isclose(y, dense, rtol=1e-3, atol=1e-3).all(-1)
        # no drops: dispatch equals dense; at 0.5 some tokens lose an expert
        assert bool(same.all()) == (cf == 8.0)


def test_moe_apply_refuses_sharded_and_unknown_paths():
    """``dispatch_sharded`` is ported (one group is ``dispatch``; token
    groups over ranks run in the tensor-parallel prefill,
    ``tests/test_torch_tensor_parallel.py``); a sequence the groups do not
    divide and unknown paths are refused by name."""
    tcfg, _, tp, _, x = layer_moe(ARCH_NAMES[0])
    y1, a1 = tmoe.moe_apply(tp, tcfg, _t(x), path="dispatch_sharded")
    y0, a0 = tmoe.moe_apply(tp, tcfg, _t(x), path="dispatch")
    assert torch.equal(y1, y0) and torch.equal(a1, a0)
    with pytest.raises(ValueError, match="does not divide into 5"):
        tmoe.moe_apply(tp, tcfg, _t(x), path="dispatch_sharded", shards=5)
    with pytest.raises(ValueError, match="unknown moe path"):
        tmoe.moe_apply(tp, tcfg, _t(x), path="sorted")


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill, decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("moe_path,use_kernel", [
    ("dispatch", False), ("dispatch", True), ("dense", False)])
def test_forward_lm_matches_reference(name, moe_path, use_kernel):
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 96)
    jlog, jaux = jax.jit(lambda p, t: jtf.forward_lm(
        p, jcfg, t, moe_path=moe_path, use_kernel=use_kernel))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        log, aux = ttf.forward_lm(tp, tcfg, _t(toks), moe_path=moe_path,
                                  use_kernel=use_kernel)
    assert log.shape == (2, 96, tcfg.vocab_size)
    assert float(aux) > 0.0
    _close(log, jlog, **F32)
    _close(aux, jaux, **F32)


def _grads(params, fn):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = fn(p)
    loss.backward()
    return loss, tree_map(lambda t: t.grad, p)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_lm_with_aux_and_grads_match_reference(name):
    """``loss + router_aux_coef * aux`` with ``remat`` on, and the
    gradients of every parameter (router and expert banks included)."""
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 64, seed=2)
    mask = (np.random.default_rng(2).random((2, 64)) > 0.2).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_lm(p, jcfg, jbatch, remat=True),
        has_aux=True))(jp)
    tbatch = {"tokens": _t(toks), "mask": _t(mask)}
    fn = treg.loss_fn(tcfg, remat=True)
    _, metrics = fn(tp, tbatch)
    _close(metrics["aux"], jm["aux"], **F32)
    _close(metrics["xent"], jm["xent"], **F32)
    loss, grads = _grads(tp, lambda p: fn(p, tbatch)[0])
    _close(loss, jl, **F32)
    assert float(loss.detach()) > float(metrics["xent"])   # aux is added
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
    assert set(st["stack"]["b0"]) == {"k", "v"}     # aux popped out
    assert st["tail"] == {} and jst["tail"] == {}
    assert_trees_close(st["stack"], jax.tree.map(np.asarray, jst["stack"]),
                       **F32)


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("moe_path", ["dense", "dispatch"])
@pytest.mark.parametrize("cache", ["f32", "quant"])
def test_decode_step_matches_reference(name, moe_path, cache):
    """Teacher-forced decode of 72 tokens (past mixtral's window of 64)
    into an 80-slot cache: logits at every step and the caches at the
    end."""
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 72, seed=4)
    quant = cache == "quant"
    jc = jreg.init_cache(jp, jcfg, 2, 80, quant=quant)
    tc = treg.init_cache(tp, tcfg, 2, 80, quant=quant)
    jstep = jax.jit(jstrat.make_serve_step(jcfg, moe_path=moe_path))
    tstep = make_serve_step(tcfg, moe_path=moe_path)
    for pos in range(toks.shape[1]):
        jlog, jc = jstep(jp, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        with torch.no_grad():
            log, same = tstep(tp, tc, _t(toks[:, pos]), pos)
        assert same is tc
        _close(log, jlog, **F32)
    jc = jax.tree.map(np.asarray, jc)
    if quant:
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
    """The loop decodes MoE on the dense path: traffic and greedy ids
    exactly equal."""
    tcfg, jcfg, tp, jp = model(name)
    jl = jloop.ServingLoop(JStore(params=jp), jcfg, batch=3, prompt_len=5,
                           tokens=6, seed=7)
    tl = ServingLoop(GlobalModelStore(params=tp), tcfg, batch=3,
                     prompt_len=5, tokens=6, seed=7)
    prompts = tl._traffic(0)
    np.testing.assert_array_equal(prompts, jl._traffic(0))
    jids, _ = jl.decode(prompts)
    ids, dt = tl.decode(prompts)
    assert dt > 0
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_serve_launcher_runs_moe_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--batch", "2",
                "--prompt-len", "3", "--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "phi3.5-moe-42b-a6.6b-reduced (moe): batch=2, 4 tokens/seq" in out
    assert "ids[0] = [" in out


# ---------------------------------------------------------------------------
# configs, counts, init, bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b"])
def test_param_counts_exact_at_full_width(name):
    cfg, jcfg = ARCHS[name], jget_arch(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert treg.param_count(cfg) == jreg.param_count(jcfg)
    assert treg.active_param_count(cfg) == jreg.active_param_count(jcfg)
    if name.startswith("phi3.5"):
        assert treg.param_count(cfg) == 41_872_527_360


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_reduced_configs_and_init_match_reference(name):
    """The reduced config equals the reference's field for field; the
    port's own init gives the reference's tree (keys, shapes) with the
    router and banks at stddev d^-0.5 (down f^-0.5)."""
    tcfg, jcfg, tp, jp = model(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    own = treg.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert_trees_close(
        jax.tree.map(lambda t: np.zeros(t.shape), own),
        jax.tree.map(lambda a: np.zeros(np.shape(a)), jp), rtol=0, atol=0)
    again = treg.init(0, tcfg, device="cpu")
    assert torch.equal(own["stack"]["b0"]["moe"]["down"],
                       again["stack"]["b0"]["moe"]["down"])
    m = own["stack"]["b0"]["moe"]
    assert "mlp" not in own["stack"]["b0"]
    for key, fan in (("gate", tcfg.d_model), ("up", tcfg.d_model),
                     ("down", tcfg.d_ff)):
        assert abs(float(m[key].std()) * fan ** 0.5 - 1.0) < 0.05


def test_bridge_carries_the_moe_subtree():
    tcfg, jcfg, tp, jp = model(ARCH_NAMES[0])
    jm = jax.tree.map(np.asarray, jp["stack"]["b0"]["moe"])
    tm = bridge.params_from_jax(jm, device="cpu")
    assert set(tm) == {"router", "gate", "up", "down"}
    assert_trees_close(tm, jm, rtol=0, atol=0)
    assert_trees_close(bridge.params_to_numpy(tm), jm, rtol=0, atol=0)
