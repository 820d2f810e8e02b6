"""The port's bf16 prefill against the reference's, on the CPU.

The reference builds its LMs in bf16 at production scale
(``registry.init(key, cfg, jnp.bfloat16)``); on the card the port's bf16
prefill runs the tensor-core kernels of ``gmm``, ``flash_attention`` and
``ssd_scan``, here their plain versions (``use_kernel=True`` on CPU
tensors). Both packages get the same weights, drawn by the reference in f32
and cast to bf16 on each side (both round to nearest even), and the same
tokens drawn with numpy; the reference's Pallas kernels run in interpret
mode, as its own tests run them.

Tolerance. Each framework rounds the activations to bf16 at its own
points, and the differences pass through every layer, so neither bf16
prefill is the exact answer. The anchor is the reference's prefill in f32
on the same bf16-valued weights. For the logits and every state leaf, the
port's relative distance to the anchor (Frobenius) must be at most
``ANCHOR_FACTOR`` x the reference's own: the port may cost no more
accuracy than the reference's bf16 rounding does. The reference's distance
must stay under ``PLAIN_MAX``, far below the ~1.4 of an anchor on other
weights or tokens. MoE routing ids must agree for every token whose top-k
margin exceeds ``ROUTE_TOL`` on both sides, the rule of
``assert_margins_clear`` with the margin two of ``tests/test_kernels.py``'s
bf16 tolerances (3e-2 + 3e-2) wide (each side's probabilities, at most 1,
may move by one); bf16 router logits tie often, so the rule picks the
tokens rather than asserting that all are clear, and every layer must have
some.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.distributed import strategies as jstrat
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import make_prefill_step
from repro_torch.models import moe as tmoe
from repro_torch.models import registry
from repro_torch.optim import tree_leaves, tree_map
from test_torch_parity_helpers import flat

ANCHOR_FACTOR = 2.0
PLAIN_MAX = 0.25
ROUTE_TOL = 2 * (3e-2 + 3e-2)
NAMES = ["qwen1.5-0.5b-reduced", "phi3.5-moe-42b-a6.6b-reduced",
         "mamba2-780m-reduced"]


def _bf16_models(name):
    """(port cfg, reference cfg, port bf16 params, reference bf16 params)
    from one f32 draw of the reference; the anchor's weights are the
    reference's bf16 params in f32."""
    jcfg = jget_arch(name)
    jp = jax.tree.map(np.asarray, jax.jit(lambda key: jreg.init(key, jcfg))(
        jax.random.PRNGKey(0)))
    tp = tree_map(lambda t: t.to(torch.bfloat16),
                  bridge.params_from_jax(jp, device="cpu"))
    assert {t.dtype for t in tree_leaves(tp)} == {torch.bfloat16}
    jpb = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jp)
    return get_arch(name), jcfg, tp, jpb


def _rel(x, anchor):
    x, anchor = np.asarray(x, np.float32), np.asarray(anchor, np.float32)
    return float(np.linalg.norm(x - anchor) / np.linalg.norm(anchor))


def _close(got, want, anchor):
    """The port's ``got`` no further from the f32 ``anchor`` than
    ``ANCHOR_FACTOR`` x the reference's bf16 ``want`` is."""
    ref = _rel(want, anchor)
    assert ref <= PLAIN_MAX
    assert _rel(got, anchor) <= ANCHOR_FACTOR * ref


def _margins(probs, k):
    top = np.sort(np.asarray(probs, np.float32), axis=-1)[..., ::-1]
    return top[..., k - 1] - top[..., k]


@pytest.mark.parametrize("name", NAMES)
def test_bf16_prefill_matches_reference(name, monkeypatch):
    tcfg, jcfg, tp, jp = _bf16_models(name)
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, size=(2, 80)).astype(np.int32)

    # each side's routing ids and probabilities, one entry a MoE layer
    jroutes, troutes = [], []
    jroute, troute = jmoe._route, tmoe._route

    def jrecord(p, cfg, xf):
        w, ids, aux = jroute(p, cfg, xf)
        probs = jax.nn.softmax((xf @ p["router"]["kernel"])
                               .astype(jnp.float32), -1)
        jax.debug.callback(lambda i, pr: jroutes.append(
            (np.asarray(i), np.asarray(pr))), ids, probs)
        return w, ids, aux

    def trecord(p, cfg, xf):
        w, ids, aux = troute(p, cfg, xf)
        probs = torch.softmax((xf @ p["router"]["kernel"]).float(), -1)
        troutes.append((ids.numpy(), probs.numpy()))
        return w, ids, aux

    monkeypatch.setattr(jmoe, "_route", jrecord)
    monkeypatch.setattr(tmoe, "_route", trecord)
    jlog, jst = jax.jit(jstrat.make_prefill_step(jcfg, use_kernel=True))(
        jp, {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    monkeypatch.setattr(jmoe, "_route", jroute)
    alog, ast = jax.jit(jstrat.make_prefill_step(jcfg))(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp),
        {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        log, st = make_prefill_step(tcfg, use_kernel=True)(
            tp, {"tokens": torch.tensor(toks)})

    assert log.dtype == torch.bfloat16 and jlog.dtype == jnp.bfloat16
    assert log.shape == (2, tcfg.vocab_size)
    _close(log.float().numpy(), jlog.astype(jnp.float32), alog)
    assert set(st["stack"]["b0"]) == ({"ssm", "conv"} if tcfg.ssm
                                      else {"k", "v"})
    assert {t.dtype for t in tree_leaves(st["stack"])} == {torch.bfloat16}
    got = flat(tree_map(lambda t: t.float(), st["stack"]))
    want = flat(jax.tree.map(lambda a: a.astype(jnp.float32), jst["stack"]))
    anchor = flat(ast["stack"])
    assert sorted(got) == sorted(want) == sorted(anchor)
    for key in want:
        _close(got[key], want[key], anchor[key])

    if tcfg.moe is None:
        assert jroutes == [] and troutes == []
        return
    assert len(jroutes) == len(troutes) == tcfg.num_layers
    k = tcfg.moe.top_k
    for (jids, jprobs), (tids, tprobs) in zip(jroutes, troutes):
        clear = np.minimum(_margins(jprobs, k), _margins(tprobs, k)) \
            > ROUTE_TOL
        assert clear.any()
        np.testing.assert_array_equal(np.sort(tids[clear], -1),
                                      np.sort(jids[clear], -1))


@pytest.mark.parametrize("name", NAMES)
def test_bf16_init_is_the_f32_init_cast(name):
    """``registry.init(..., dtype=bfloat16)`` draws in f32 and casts, so the
    f32 model cast to bf16 is the same model bit for bit (the card's bf16
    prefills cast the f32 model instead of drawing again)."""
    cfg = get_arch(name)
    b = tree_leaves(registry.init(0, cfg, dtype=torch.bfloat16, device="cpu"))
    f = tree_leaves(registry.init(0, cfg, device="cpu"))
    assert len(b) == len(f)
    for t, u in zip(b, f):
        assert t.dtype == torch.bfloat16 and u.dtype == torch.float32
        assert torch.equal(t, u.to(torch.bfloat16))
