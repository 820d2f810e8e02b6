"""The port's SSM serving path (mamba2, the zamba2 hybrid) against the
reference, on the CPU.

Both packages get the same inputs, made with numpy from one seed; the
reduced mamba2-780m and zamba2-7b, and a 5-layer hybrid whose (mamba, attn)
pattern runs the shared attention block in two cycles, get the reference's
parameters through ``bridge.params_from_jax``. The reference's Pallas SSD
scan runs in interpret mode, as its own tests run it. Tolerances: the scan
within 5e-4 (``tests/test_kernels.py:104-107``: the cumsum and the sums run
in another order), the naive recurrence within 1e-4 (``:131``); the layers
and models within 2e-4 (f32 sums in another order, compounding over a few
matmuls; ``tests/test_kernels.py:12``); bf16 outputs within one bf16 ulp
plus the scan's 5e-4.
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
from repro.models import registry as jreg
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.serve import ServingLoop
from repro_torch.distributed import make_prefill_step, make_serve_step
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.optim import tree_map
from test_torch_parity_helpers import assert_trees_close
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-4, atol=2e-4)
SCAN = dict(rtol=5e-4, atol=5e-4)
STEPWISE = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2 ** -7, atol=5e-4)
HYBRID = "zamba2-7b-reduced-hybrid5"
ARCH_NAMES = ["mamba2-780m-reduced", "zamba2-7b-reduced", HYBRID]
# (B, S, H, P, N, chunk): the reference sweep (tests/test_kernels.py:89-93)
# and a ragged S over three chunks
SCAN_SHAPES = [(1, 64, 2, 32, 16, 16), (2, 96, 3, 64, 32, 32),
               (1, 256, 1, 64, 128, 64), (2, 70, 3, 16, 8, 32)]


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()
                                          if isinstance(got, torch.Tensor)
                                          else got, np.float32),
                               np.asarray(want, np.float32), **tol)



def configs(name):
    """(port cfg, reference cfg); ``HYBRID`` is reduced zamba2-7b with the
    pattern (mamba, attn) over 5 layers: 2 cycles and a mamba tail."""
    if name != HYBRID:
        return get_arch(name), jget_arch(name)
    kw = dict(name=HYBRID, layer_pattern=("mamba", "attn"), num_layers=5)
    return (dataclasses.replace(get_arch("zamba2-7b-reduced"), **kw),
            dataclasses.replace(jget_arch("zamba2-7b-reduced"), **kw))


_MODELS = {}


def model(name):
    """(port cfg, reference cfg, port params, reference params), built once."""
    if name not in _MODELS:
        tcfg, jcfg = configs(name)
        jp = jax.jit(lambda key: jreg.init(key, jcfg))(jax.random.PRNGKey(0))
        tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _MODELS[name] = (tcfg, jcfg, tp, jp)
    return _MODELS[name]


def tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def scan_inputs(B, S, H, P, N, seed=0):
    """The reference kernel test's distributions (tests/test_kernels.py:
    95-100), drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(B, S, H)), 0.0).astype(np.float32)
    A = (-np.exp(rng.normal(size=(H,)) * 0.3)).astype(np.float32)
    b = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    c = (rng.normal(size=(B, S, N)) * 0.5).astype(np.float32)
    D = np.linspace(0.5, 1.5, H).astype(np.float32)
    return x, dt, A, b, c, D


# ---------------------------------------------------------------------------
# the scan: plain version, wrapper, adapter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,P,N,chunk", SCAN_SHAPES)
def test_ssd_scan_ref_matches_pallas_kernel_and_reference(B, S, H, P, N,
                                                          chunk):
    """The plain version and ``ops.ssd_scan`` (the plain version on the
    CPU) against the reference's Pallas kernel in interpret mode and its
    ``ssd_chunked``: y and the final state."""
    args = scan_inputs(B, S, H, P, N, seed=S + H)
    jargs = [jnp.asarray(a) for a in args]
    want = [jops.ssd_scan(*jargs, chunk=chunk),
            jref.ssd_scan_ref(*jargs, chunk=chunk)]
    targs = [_t(a) for a in args]
    for got in (tref.ssd_scan_ref(*targs, chunk=chunk),
                tops.ssd_scan(*targs, chunk=chunk)):
        assert got[0].shape == (B, S, H, P) and got[0].dtype == torch.float32
        assert got[1].shape == (B, H, N, P) and got[1].dtype == torch.float32
        for y, st in want:
            _close(got[0], y, **SCAN)
            _close(got[1], st, **SCAN)


def test_ssd_scan_ref_equals_stepwise_recurrence():
    """The chunked scan equals the naive per-step recurrence
    (tests/test_kernels.py:110-131), y and the final state, with D."""
    B, S, H, P, N = 1, 40, 2, 16, 8
    x, dt, A, b, c, D = scan_inputs(B, S, H, P, N, seed=7)
    y, st = tref.ssd_scan_ref(*map(_t, (x, dt, A, b, c, D)), chunk=8)
    state = np.zeros((B, H, N, P))
    ys = []
    for t in range(S):
        decay = np.exp(dt[:, t] * A)                          # (B, H)
        state = state * decay[..., None, None] + np.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], b[:, t], x[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", c[:, t], state)
                  + x[:, t] * D[None, :, None])
    _close(y, np.stack(ys, axis=1), **STEPWISE)
    _close(st, state, **STEPWISE)


def test_ssd_scan_bf16_matches_reference():
    """bf16 x, b, c: computed in f32 and y cast back, as the reference's
    adapter does; the state stays f32."""
    args = scan_inputs(2, 96, 3, 64, 32, seed=3)
    jd = [jnp.asarray(a).astype(jnp.bfloat16) if i in (0, 3, 4)
          else jnp.asarray(a) for i, a in enumerate(args)]
    jy, jst = jops.ssd_scan(*jd, chunk=32)
    td = [_t(a, torch.bfloat16) if i in (0, 3, 4) else _t(a)
          for i, a in enumerate(args)]
    for y, st in (tops.ssd_scan(*td, chunk=32),
                  tref.ssd_scan_ref(*td, chunk=32)):
        assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
        _close(y, np.asarray(jy.astype(jnp.float32)), **BF16)
        _close(st, jst, **SCAN)


def test_ops_ssd_scan_grads_match_reference():
    """Gradients of ``ops.ssd_scan`` (backward through the plain version)
    against ``jax.grad`` of the reference's ``ssd_chunked``, with respect
    to all six inputs, through y and the final state."""
    args = scan_inputs(2, 70, 3, 16, 8, seed=4)
    rng = np.random.default_rng(5)
    wy = rng.normal(size=(2, 70, 3, 16)).astype(np.float32)
    ws = rng.normal(size=(2, 3, 8, 16)).astype(np.float32)

    def jloss(*a):
        y, st = jssm.ssd_chunked(*a, 32)
        return jnp.sum(y * wy) + jnp.sum(st * ws)

    jg = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_() for a in args]
    y, st = tops.ssd_scan(*leaves, chunk=32)
    ((y * _t(wy)).sum() + (st * _t(ws)).sum()).backward()
    for got, want in zip(leaves, jg):
        _close(got.grad, want, **F32)


def test_ssd_scan_wrapper_checks_and_runs_no_kernel_on_cpu():
    x, dt, A, b, c, D = map(_t, scan_inputs(1, 64, 2, 32, 16))
    with pytest.raises(ValueError):                 # dt does not fit
        tss.ssd_scan(x, dt[:, :10], A, b, c, D, chunk=16)
    with pytest.raises(ValueError):
        tss.ssd_scan(x, dt, A, b[..., :8], c, D, chunk=16)
    with pytest.raises(TypeError):                  # mixed dtypes
        tss.ssd_scan(x, dt, A, b.to(torch.bfloat16), c, D, chunk=16)
    with pytest.raises(TypeError):
        tss.ssd_scan(x.double(), dt, A, b.double(), c.double(), D, chunk=16)
    with pytest.raises(ValueError):
        tss.ssd_scan(x, dt, A, b, c, D, chunk=0)
    before = tss.launches
    y, st = tss.ssd_scan(x, dt, A, b, c, D, chunk=16)
    assert y.shape == x.shape and st.shape == (1, 2, 16, 32)
    assert tss.launches == before                   # the CPU runs no kernel


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def layer_ssm(name="mamba2-780m-reduced"):
    """One layer's SSM params and a normed-scale input of (2, 70, d)."""
    tcfg, jcfg, tp, jp = model(name)
    lp = jax.tree.map(lambda a: np.asarray(a)[0], jp["stack"]["b0"]["ssm"])
    u = (np.random.default_rng(1).normal(size=(2, 70, tcfg.d_model))
         .astype(np.float32))
    return tcfg, jcfg, bridge.params_from_jax(lp, device="cpu"), lp, u


def test_causal_conv_matches_reference():
    tcfg, jcfg, tp, jp, _ = layer_ssm()
    conv_dim = tp["conv_w"].shape[1]
    xbc = np.random.default_rng(2).normal(size=(2, 70, conv_dim)).astype(
        np.float32)
    _close(tssm._causal_conv(tp, _t(xbc), tcfg),
           jssm._causal_conv(jp, jnp.asarray(xbc), jcfg), **F32)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssm_forward_matches_reference(use_kernel):
    """out and both decode states; ``use_kernel`` routes the scan through
    ``ops.ssd_scan`` (the reference's forward keeps ``ssd_chunked``)."""
    tcfg, jcfg, tp, jp, u = layer_ssm()
    jout, jst = jssm.ssm_forward(jp, jcfg, jnp.asarray(u))
    out, st = tssm.ssm_forward(tp, tcfg, _t(u), use_kernel=use_kernel)
    _close(out, jout, **F32)
    assert set(st) == {"ssm", "conv"}
    assert st["conv"].shape == (2, tcfg.ssm.d_conv - 1, tp["conv_w"].shape[1])
    assert_trees_close(st, jax.tree.map(np.asarray, jst), **F32)


def test_ssm_decode_step_matches_reference():
    """Twelve recurrent steps from the zero state: outputs and states."""
    tcfg, jcfg, tp, jp, u = layer_ssm()
    jstate = jssm.ssm_init_state(jcfg, 2)
    state = tssm.ssm_init_state(tcfg, 2)
    for t in range(12):
        jout, jstate = jssm.ssm_decode_step(jp, jcfg,
                                            jnp.asarray(u[:, t:t + 1]),
                                            jstate)
        out, state = tssm.ssm_decode_step(tp, tcfg, _t(u[:, t:t + 1]), state)
        _close(out, jout, **F32)
    assert_trees_close(state, jax.tree.map(np.asarray, jstate), **F32)
    # the recurrence ends where the chunked forward over the same steps does
    _, fst = tssm.ssm_forward(tp, tcfg, _t(u[:, :12]))
    _close(state["ssm"], fst["ssm"], **F32)


# ---------------------------------------------------------------------------
# the model: forward, loss, prefill, decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_lm_matches_reference(name, use_kernel):
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 70)
    jlog, _ = jax.jit(lambda p, t: jtf.forward_lm(
        p, jcfg, t, use_kernel=use_kernel))(jp, jnp.asarray(toks))
    with torch.no_grad():
        log, aux = ttf.forward_lm(tp, tcfg, _t(toks), use_kernel=use_kernel)
    assert log.shape == (2, 70, tcfg.vocab_size) and float(aux) == 0.0
    _close(log, jlog, **F32)


def _grads(params, fn):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = fn(p)
    loss.backward()
    # a parameter the loss never reads (reduced zamba2's shared block: its
    # two layers are both mamba) has no grad in torch, zeros in JAX
    return loss, tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                          else t.grad, p)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_lm_and_grads_match_reference(name):
    """The loss with ``remat`` on, through the kernels' adapters (the SSD
    scan's backward goes through the plain version), and the gradients of
    every parameter, the shared attention block's included."""
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 48, seed=2)
    mask = (np.random.default_rng(2).random((2, 48)) > 0.2).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_lm(p, jcfg, jbatch, remat=True, use_kernel=True),
        has_aux=True))(jp)
    tbatch = {"tokens": _t(toks), "mask": _t(mask)}
    fn = treg.loss_fn(tcfg, remat=True, use_kernel=True)
    loss, grads = _grads(tp, lambda p: fn(p, tbatch)[0])
    _close(loss, jl, **F32)
    assert_trees_close(grads, jax.tree.map(np.asarray, jg), **F32)


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_step_matches_reference(name, use_kernel):
    """Last-token logits and every layer's decode state: SSM and conv for
    mamba layers, k/v for the shared attention positions."""
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 80, seed=3)
    jlog, jst = jax.jit(jstrat.make_prefill_step(
        jcfg, use_kernel=use_kernel))(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        log, st = make_prefill_step(tcfg, use_kernel=use_kernel)(
            tp, {"tokens": _t(toks)})
    assert log.shape == (2, tcfg.vocab_size)
    _close(log, jlog, **F32)
    assert set(st["stack"]["b0"]) == {"ssm", "conv"}
    if name == HYBRID:
        assert set(st["stack"]["b1"]) == {"k", "v"}
        assert set(st["tail"]) == {"b0"}
    assert_trees_close(st, jax.tree.map(np.asarray, jst), **F32)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_step_matches_reference(name):
    """Teacher-forced decode of 24 tokens into a 32-slot cache, writing the
    SSM and conv states (and the shared block's per-position KV caches) in
    place: logits at every step, the caches at the end, then greedy ids."""
    tcfg, jcfg, tp, jp = model(name)
    toks = tokens(tcfg, 2, 24, seed=4)
    jc = jreg.init_cache(jp, jcfg, 2, 32)
    tc = treg.init_cache(tp, tcfg, 2, 32)
    jstep = jax.jit(jstrat.make_serve_step(jcfg))
    tstep = make_serve_step(tcfg)
    for pos in range(toks.shape[1]):
        jlog, jc = jstep(jp, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        with torch.no_grad():
            log, same = tstep(tp, tc, _t(toks[:, pos]), pos)
        assert same is tc
        _close(log, jlog, **F32)
    assert_trees_close(tc, jax.tree.map(np.asarray, jc), **F32)
    jtok, tok = jnp.argmax(jlog, -1), torch.argmax(log, -1)
    for pos in range(24, 30):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlog, jc = jstep(jp, jc, jtok, jnp.int32(pos))
        with torch.no_grad():
            log, _ = tstep(tp, tc, tok, pos)
        _close(log, jlog, **F32)
        jtok, tok = jnp.argmax(jlog, -1), torch.argmax(log, -1)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_serving_loop_matches_reference(name):
    """Traffic and greedy ids exactly equal."""
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


def test_serve_launcher_serves_zamba2_reduced_by_default(capsys):
    from repro_torch.launch import serve
    serve.main(["--batch", "2", "--prompt-len", "3", "--tokens", "4",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "zamba2-7b-reduced (hybrid): batch=2, 4 tokens/seq" in out
    assert "ids[0] = [" in out


# ---------------------------------------------------------------------------
# configs, counts, init, bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-7b"])
def test_param_counts_exact_at_full_width(name):
    cfg, jcfg = ARCHS[name], jget_arch(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert treg.param_count(cfg) == jreg.param_count(jcfg)
    assert treg.active_param_count(cfg) == jreg.active_param_count(jcfg)
    if name == "mamba2-780m":
        assert treg.param_count(cfg) == 857_379_072


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_reduced_configs_and_init_match_reference(name):
    """The config equals the reference's field for field; the port's own
    init gives the reference's tree (keys, shapes: ``shared`` for the
    hybrids, no stack entry at the shared positions) and its constants
    (A_log, D, dt_bias, conv_b)."""
    tcfg, jcfg, tp, jp = model(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    own = treg.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert_trees_close(
        jax.tree.map(lambda t: np.zeros(t.shape), own),
        jax.tree.map(lambda a: np.zeros(np.shape(a)), jp), rtol=0, atol=0)
    assert ("shared" in own) == (tcfg.arch_type == "hybrid")
    if name == HYBRID:
        assert set(own["stack"]) == {"b0"} and set(own["tail"]) == {"b0"}
    s = own["stack"]["b0"]["ssm"]
    js = jax.tree.map(np.asarray, jp["stack"]["b0"]["ssm"])
    for key in ("A_log", "D", "dt_bias", "conv_b"):
        _close(s[key], js[key], rtol=1e-6, atol=1e-6)
    assert abs(float(s["conv_w"].std()) / 0.1 - 1.0) < 0.1


def test_bridge_carries_the_shared_block():
    tcfg, jcfg, tp, jp = model(HYBRID)
    js = jax.tree.map(np.asarray, jp["shared"])
    ts = bridge.params_from_jax(js, device="cpu")
    assert set(ts) == {"ln1", "attn", "ln2", "mlp"}
    assert_trees_close(ts, js, rtol=0, atol=0)
    assert_trees_close(bridge.params_to_numpy(tp["shared"]), js, rtol=0,
                       atol=0)
