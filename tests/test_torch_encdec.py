"""The port's encoder-decoder (whisper-tiny) and vision-language
(llava-next-34b) families against the reference, on the CPU.

Both packages get the same inputs, made with numpy from one seed; the
reduced models get the reference's parameters through
``bridge.params_from_jax``. The reference's Pallas flash kernel runs in
interpret mode, as its own tests run it; the port's wrapper runs its plain
version on CPU tensors. Tolerances: f32 results within 2e-4
(``tests/test_kernels.py``); decode against the full forward within 2e-2,
the rule of ``tests/test_arch_smoke.py::test_decode_matches_forward``.
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
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import registry as jreg
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.serve import ServingLoop
from repro_torch.distributed import make_prefill_step
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as ted
from repro_torch.models import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.optim import tree_leaves, tree_map
from test_torch_parity_helpers import assert_trees_close, flat
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

F32 = dict(rtol=2e-4, atol=2e-4)
STEP = dict(rtol=2e-2, atol=2e-2)
WHISPER, LLAVA = "whisper-tiny-reduced", "llava-next-34b-reduced"
NAMES = [WHISPER, LLAVA]


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


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


def inputs(cfg, B, S, seed=0):
    """{tokens} plus the family's stub frontend output: whisper's
    (B, encoder_seq, d) audio embeddings, llava's (B, patches, d) patch
    embeddings; numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(B, S)).astype(np.int32)}
    if cfg.arch_type == "audio":
        batch["audio_embeds"] = (rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    else:
        batch["patch_embeds"] = (rng.normal(
            size=(B, cfg.num_patch_tokens, cfg.d_model)) * 0.1).astype(
                np.float32)
    return batch


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs, init, parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_reduced_configs_and_init_match_reference(name):
    """The config (full and reduced) equals the reference's field for
    field; the port's own init gives the reference's tree (keys, shapes,
    dtypes) with its distributions, and one seed gives one tree."""
    tcfg, jcfg, tp, jp = model(name)
    base = name[: -len("-reduced")]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(ARCHS[base]) == dataclasses.asdict(
        jget_arch(base))
    own = treg.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    want = {k: np.shape(v) for k, v in flat(jp).items()}
    assert {k: tuple(v.shape) for k, v in flat(own).items()} == want
    assert all(t.dtype == torch.float32 for t in tree_leaves(own))
    again = treg.init(0, tcfg, device="cpu")
    assert torch.equal(own["embed"]["embedding"], again["embed"]["embedding"])
    if tcfg.arch_type == "audio":
        assert set(own) == {"embed", "enc_stack", "enc_norm", "dec_stack",
                            "final_norm"}
        blk = own["dec_stack"]
        assert blk["ln_x"]["bias"].abs().max() == 0.0
        assert float(blk["ln1"]["scale"].min()) == 1.0
        std = float(blk["cross_attn"]["wq"]["kernel"].std())
    else:
        assert "lm_head" in own and "stack" in own
        std = float(own["stack"]["b0"]["mlp"]["up"]["kernel"].std())
    assert abs(std * tcfg.d_model ** 0.5 - 1.0) < 0.05


def test_param_count_exact_at_full_width():
    """Counted on the meta device (nothing drawn): the reference's counts."""
    for name, want in (("whisper-tiny", 36_448_128),
                       ("llava-next-34b", 34_388_917_248)):
        cfg = ARCHS[name]
        assert treg.param_count(cfg) == want == jreg.param_count(
            jget_arch(name))
        assert cfg.param_count() == want
        assert all(t.is_meta for t in tree_leaves(treg.shapes(cfg)))


# ---------------------------------------------------------------------------
# cross attention and the encoder
# ---------------------------------------------------------------------------

def test_cross_attention_matches_reference():
    tcfg, jcfg, tp, jp = model(WHISPER)
    p = jax.tree.map(lambda a: np.asarray(a)[0],
                     jp["dec_stack"]["cross_attn"])
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 11, tcfg.d_model)).astype(np.float32)
    jkv = jattn.cross_attention_kv(p, jcfg, jnp.asarray(enc))
    tpp = bridge.params_from_jax(p, device="cpu")
    tkv = tattn.cross_attention_kv(tpp, tcfg, _t(enc))
    for a, b in zip(tkv, jkv):
        assert tuple(a.shape) == (2, 11, tcfg.num_kv_heads, tcfg.head_dim)
        _close(a, b, **F32)
    _close(tattn.cross_attention(tpp, tcfg, _t(x), tkv),
           jattn.cross_attention(p, jcfg, jnp.asarray(x), jkv), **F32)


def test_encode_matches_reference():
    tcfg, jcfg, tp, jp = model(WHISPER)
    audio = inputs(tcfg, 2, 4, seed=2)["audio_embeds"]
    want = jax.jit(lambda p, a: jed.encode(p, jcfg, a))(jp,
                                                        jnp.asarray(audio))
    with torch.no_grad():
        got = ted.encode(tp, tcfg, _t(audio))
    assert tuple(got.shape) == (2, tcfg.encoder_seq, tcfg.d_model)
    _close(got, want, **F32)


# ---------------------------------------------------------------------------
# forward, loss and grads, prefill
# ---------------------------------------------------------------------------

def _jforward(jcfg, use_kernel):
    fn = jreg.forward_fn(jcfg, use_kernel=use_kernel)
    return jax.jit(lambda p, b: fn(p, b)[0])


@pytest.mark.parametrize("name,use_kernel", [(WHISPER, False),
                                             (LLAVA, False), (LLAVA, True)])
def test_forward_matches_reference(name, use_kernel):
    """Logits over every position: whisper's decoder over its audio,
    llava's patch prefix and text (kernel path: the plain flash version)."""
    tcfg, jcfg, tp, jp = model(name)
    batch = inputs(tcfg, 2, 80)
    want = _jforward(jcfg, use_kernel)(jp, _jb(batch))
    with torch.no_grad():
        got, aux = treg.forward_fn(tcfg, use_kernel=use_kernel)(tp,
                                                                _tb(batch))
    n_prefix = tcfg.num_patch_tokens if tcfg.arch_type == "vlm" else 0
    assert tuple(got.shape) == (2, 80 + n_prefix, tcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want, **F32)


def _grads(params, fn):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss = fn(p)
    loss.backward()
    return loss, tree_map(lambda t: t.grad, p)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunked", [False, True])
def test_loss_and_grads_match_reference(name, chunked, monkeypatch):
    """Plain and chunked readout (threshold 0, chunk 16 in both packages),
    a mask where the reference takes one, ``remat`` on, and the gradient of every parameter. llava's loss
    skips its patch prefix; whisper's chunked branch is the
    encoder-decoder's own (``loss_encdec``)."""
    if chunked:
        for mod in (jtf, ttf):
            monkeypatch.setattr(mod, "LOSS_CHUNK_MIN_ELEMENTS", 0)
            monkeypatch.setattr(mod, "LOSS_CHUNK", 16)
    tcfg, jcfg, tp, jp = model(name)
    batch = inputs(tcfg, 2, 64, seed=3)
    if chunked or tcfg.arch_type != "audio":
        # the reference's unchunked encoder-decoder loss takes no mask (it
        # passes the (B, S) mask against S - 1 targets), nor does the port
        batch["mask"] = (np.random.default_rng(3).random((2, 64))
                         > 0.2).astype(np.float32)
    jfn = jreg.loss_fn(jcfg, remat=True)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jfn(p, _jb(batch)), has_aux=True))(jp)
    fn = treg.loss_fn(tcfg, remat=True)
    loss, grads = _grads(tp, lambda p: fn(p, _tb(batch))[0])
    _close(loss, jl, **F32)
    assert_trees_close(grads, jax.tree.map(np.asarray, jg), **F32)
    if tcfg.arch_type == "vlm":
        # the prefix is skipped: dropping the patches changes the loss
        text = {k: v for k, v in batch.items() if k != "patch_embeds"}
        with torch.no_grad():
            assert float(fn(tp, _tb(text))[0]) != float(loss)


@pytest.mark.parametrize("name,use_kernel", [(WHISPER, False),
                                             (WHISPER, True),
                                             (LLAVA, False), (LLAVA, True)])
def test_prefill_step_matches_reference(name, use_kernel):
    """The encoder-decoder's step returns the last-token logits alone (and
    ignores ``use_kernel``, as the reference's); llava's returns them with
    its decode states, the patch positions included."""
    tcfg, jcfg, tp, jp = model(name)
    batch = inputs(tcfg, 2, 80, seed=4)
    jout = jax.jit(jstrat.make_prefill_step(jcfg, use_kernel=use_kernel))(
        jp, _jb(batch))
    with torch.no_grad():
        out = make_prefill_step(tcfg, use_kernel=use_kernel)(tp, _tb(batch))
    if tcfg.arch_type == "audio":
        assert tuple(out.shape) == (2, tcfg.vocab_size)
        _close(out, jout, **F32)
        return
    (log, st), (jlog, jst) = out, jout
    assert tuple(log.shape) == (2, tcfg.vocab_size)
    _close(log, jlog, **F32)
    assert st["stack"]["b0"]["k"].shape[2] == 80 + tcfg.num_patch_tokens
    assert_trees_close(st["stack"], jax.tree.map(np.asarray, jst["stack"]),
                       **F32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _caches(name, B, S, seed):
    tcfg, jcfg, tp, jp = model(name)
    audio = inputs(tcfg, B, 1, seed)["audio_embeds"] \
        if tcfg.arch_type == "audio" else None
    kw = {} if audio is None else {"audio_embeds": audio}
    jc = jreg.init_cache(jp, jcfg, B, S, **{k: jnp.asarray(v)
                                            for k, v in kw.items()})
    with torch.no_grad():
        tc = treg.init_cache(tp, tcfg, B, S, **{k: _t(v)
                                                for k, v in kw.items()})
    return tc, jc, audio


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name):
    """Teacher-forced decode of 40 tokens into a 48-slot cache: the cache
    as built (whisper's cross k/v from one encoder run), the logits at
    every step and the caches at the end. The port writes its cache in
    place."""
    tcfg, jcfg, tp, jp = model(name)
    toks = inputs(tcfg, 2, 40, seed=5)["tokens"]
    tc, jc, _ = _caches(name, 2, 48, 5)
    assert_trees_close(tc, jax.tree.map(np.asarray, jc), **F32)
    jstep = jax.jit(jreg.decode_fn(jcfg))
    tstep = treg.decode_fn(tcfg)
    for pos in range(toks.shape[1]):
        jlog, jc = jstep(jp, jc, jnp.asarray(toks[:, pos]), jnp.int32(pos))
        with torch.no_grad():
            log, same = tstep(tp, tc, _t(toks[:, pos]), pos)
        assert same is tc
        _close(log, jlog, **F32)
    assert_trees_close(tc, jax.tree.map(np.asarray, jc), **F32)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward(name):
    """Step-by-step decode against the full forward at every position
    (llava text-only, as its decode), the rule of
    ``tests/test_arch_smoke.py``."""
    tcfg, _, tp, _ = model(name)
    batch = inputs(tcfg, 2, 8, seed=6)
    tc, _, audio = _caches(name, 2, 8, 6)
    with torch.no_grad():
        if audio is not None:
            full, _ = ted.forward_encdec(tp, tcfg, _t(batch["tokens"]),
                                         _t(audio))
        else:
            full, _ = ttf.forward_lm(tp, tcfg, _t(batch["tokens"]))
        step = treg.decode_fn(tcfg, moe_path="dense")
        for pos in range(8):
            log, tc = step(tp, tc, _t(batch["tokens"][:, pos]), pos)
            _close(log, full[:, pos], **STEP)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serving_loop_serves_llava_and_refuses_whisper():
    """llava serves text-only through ``ServingLoop``: traffic ids and
    greedy ids equal to the reference's; whisper is refused with the
    reference's message."""
    tcfg, jcfg, tp, jp = model(LLAVA)
    jl = jloop.ServingLoop(JStore(params=jp), jcfg, batch=3, prompt_len=5,
                           tokens=6, seed=7)
    tl = ServingLoop(GlobalModelStore(params=tp), tcfg, batch=3,
                     prompt_len=5, tokens=6, seed=7)
    prompts = tl._traffic(0)
    np.testing.assert_array_equal(prompts, jl._traffic(0))
    ids, dt = tl.decode(prompts)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(
        jl.decode(prompts)[0]))
    assert dt > 0
    wcfg, jwcfg, wp, jwp = model(WHISPER)
    with pytest.raises(ValueError) as te:
        ServingLoop(GlobalModelStore(params=wp), wcfg)
    with pytest.raises(ValueError) as je:
        jloop.ServingLoop(JStore(params=jwp), jwcfg)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("arch", ["whisper-tiny", "llava-next-34b"])
def test_serve_launcher_runs_new_families_on_cpu(arch, capsys):
    """The launcher serves reduced whisper through its direct audio decode
    and reduced llava through the serving loop."""
    from repro_torch.launch import serve
    res = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "3",
                      "--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    kind = "audio" if arch.startswith("whisper") else "vlm"
    assert f"{arch}-reduced ({kind}): batch=2, 4 tokens/seq" in out
    assert tuple(res["ids"].shape) == (2, 4)
    assert ("hot-swapped" in out) == (kind == "vlm")


def test_audio_decode_matches_reference_decode_steps():
    """``serve.decode_audio``'s greedy ids follow the reference's decode
    steps on the same audio, prompt and params (fed the port's tokens)."""
    from repro_torch.launch import serve
    tcfg, jcfg, tp, jp = model(WHISPER)
    ids, dt, logits = serve.decode_audio(tp, tcfg, batch=2, prompt_len=3,
                                         tokens=5, seed=0)
    audio = torch.randn((2, tcfg.encoder_seq, tcfg.d_model),
                        generator=torch.Generator().manual_seed(0)) * 0.1
    prompt = torch.randint(0, tcfg.vocab_size, (2, 3),
                           generator=torch.Generator().manual_seed(1))
    jc = jreg.init_cache(jp, jcfg, 2, 8, audio_embeds=jnp.asarray(
        audio.numpy()))
    jstep = jax.jit(jreg.decode_fn(jcfg))
    for pos in range(3):
        jlog, jc = jstep(jp, jc, jnp.asarray(prompt[:, pos].numpy()),
                         jnp.int32(pos))
    tok = np.argmax(np.asarray(jlog), -1)
    for i in range(5):
        jlog, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(3 + i))
        _close(logits[:, i], jlog, **F32)
        tok = ids[:, i].numpy()
        np.testing.assert_array_equal(tok, np.argmax(np.asarray(jlog), -1))
    assert dt > 0
