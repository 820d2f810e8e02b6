"""Federated LM training on the port against the reference, on the CPU: the
token data, a vmapped MoE client update on both MoE paths, evaluation of an
LM, the LM specs of ``examples/specs/`` (``local-int8-decayK`` for 20
rounds, the two downlink specs for 3) built by ``repro.api.experiment`` and
by hand on the port, one round of reduced phi3.5-moe (dispatch path, router
aux in the loss) and of reduced mamba2-780m, and the port's LM launcher.
The fixed-cohort spec is held in tests/test_torch_sampling.py."""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.engine.client import make_client_update as jmake_update
from repro.core.engine.trainer import make_eval_fn as jmake_eval_fn
from repro.data import make_lm_clients as jmake_lm_clients
from repro.models import registry as jregistry
from repro_torch.configs import get_arch
from repro_torch.core.engine.client import make_client_update
from repro_torch.core.engine.trainer import make_eval_fn
from repro_torch.data import make_lm_clients
from repro_torch.launch import train_federated_lm
from repro_torch.models import registry
from test_torch_parity_helpers import (TOL, _np, _torch, assert_counters_equal,
                                       assert_trees_close, drift_in_steps,
                                       lm_spec, lm_trainers)
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-4


@pytest.mark.parametrize("clients,vocab,seq,spc", [
    (12, 512, 32, 64),            # the LM specs' data (reduced vocab)
    (5, 151936, 8, 3),            # qwen1.5-0.5b's full vocabulary
])
def test_make_lm_clients_matches_reference(clients, vocab, seq, spc):
    got = make_lm_clients(np.random.default_rng(3), clients, vocab, seq,
                          samples_per_client=spc)
    want = jmake_lm_clients(np.random.default_rng(3), clients, vocab, seq,
                            samples_per_client=spc)
    assert got.num_clients == want.num_clients == clients
    assert got.num_classes == want.num_classes == vocab
    for a, b in zip(got.client_x + got.client_y + [got.val_x, got.val_y],
                    want.client_x + want.client_y + [want.val_x, want.val_y]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def _lm_params(name):
    jcfg = jget_arch(name)
    return jcfg, get_arch(name), _np(jregistry.init(jax.random.PRNGKey(0),
                                                    jcfg))


@pytest.mark.parametrize("name", ["qwen1.5-0.5b-reduced",
                                  "phi3.5-moe-42b-a6.6b-reduced"])
def test_unbound_layer_stack_gives_the_indexed_gradients_bitwise(
        monkeypatch, name):
    """``forward_lm`` reads the stacked layers with one ``torch.unbind`` a
    leaf (``_unbind``); a cycle's slice as ``t[c]`` (``_index``) gives the
    same loss and gradients bit for bit."""
    from repro_torch.models import transformer
    cfg = get_arch(name)
    params = registry.init(0, cfg, device="cpu")
    assert transformer.cycle_counts(cfg)[0] > 1
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 16))).long()
    loss = registry.loss_fn(cfg)

    def grads():
        return torch.func.grad(lambda p: loss(p, {"tokens": toks})[0])(
            params), loss(params, {"tokens": toks})[0]

    got, got_loss = grads()
    monkeypatch.setattr(transformer, "_unbind", lambda tree: [
        transformer._index(tree, c)
        for c in range(len(transformer.tree_leaves(tree)[0]))])
    want, want_loss = grads()
    assert torch.equal(got_loss, want_loss)
    got, want = transformer.tree_leaves(got), transformer.tree_leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i


@pytest.mark.parametrize("moe_path", ["dense", "dispatch"])
def test_vmapped_moe_client_update_matches_reference(moe_path):
    """One client update of reduced phi3.5-moe under ``torch.func.vmap``,
    three clients, against the reference's ``jax.vmap``: the router and the
    dispatch counts must batch (no data-dependent ``.item()``, no per-client
    loop)."""
    jcfg, cfg, params = _lm_params("phi3.5-moe-42b-a6.6b-reduced")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(3, 2, 2, 16)).astype(np.int32)
    jloss = jregistry.loss_fn(jcfg, moe_path=moe_path)
    tloss = registry.loss_fn(cfg, moe_path=moe_path)
    want = jax.vmap(jmake_update(lambda p, b: jloss(p, {"tokens": b["x"]})),
                    in_axes=(None, 0, None))(
        jax.tree.map(jnp.asarray, params), {"x": jnp.asarray(toks)},
        jnp.float32(0.05))
    with warnings.catch_warnings():
        # vmap warns where an op has no batching rule and loops per client
        # (bincount did, in the dispatch counts)
        warnings.simplefilter("error", UserWarning)
        got = torch.func.vmap(
            make_client_update(lambda p, b: tloss(p, {"tokens": b["x"]})),
            in_dims=(None, 0, None))(_torch(params),
                                     {"x": torch.tensor(toks).long()}, 0.05)
    np.testing.assert_allclose(got.first_loss.numpy(),
                               np.asarray(want.first_loss), **TOL)
    np.testing.assert_allclose(got.last_loss.numpy(),
                               np.asarray(want.last_loss), **TOL)
    assert_trees_close(got.params, want.params, **TOL)


def test_eval_fn_on_an_lm_matches_reference():
    """The LM loss has no ``acc`` metric: evaluation counts accuracy 0 and
    error 1, as the reference's, over the ragged validation split."""
    jcfg, cfg, params = _lm_params("qwen1.5-0.5b-reduced")
    data = make_lm_clients(np.random.default_rng(0), 4, cfg.vocab_size, 16)
    jloss = jregistry.loss_fn(jcfg)
    tloss = registry.loss_fn(cfg)
    want = jmake_eval_fn(lambda p, b: jloss(p, {"tokens": b["x"]}), data,
                         batch_size=24)(jax.tree.map(jnp.asarray, params))
    got = make_eval_fn(lambda p, b: tloss(p, {"tokens": b["x"]}), data,
                       batch_size=24, device="cpu")(_torch(params))
    assert got["acc"] == want["acc"] == 0.0
    assert got["error"] == want["error"] == 1.0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


def test_local_int8_decayK_20_rounds_matches_reference():
    """``local-int8-decayK`` (reduced qwen1.5-0.5b, 12 clients, 4 a round,
    seq 32, K_r-rounds from 8, int8 uplink) for its 20 rounds: counters and
    client ids exact, losses allclose, and every parameter within one int8
    quantisation step of the run's movement of its leaf (a value near a
    rounding boundary may quantise one step apart in the two packages;
    ROADMAP C5)."""
    spec = lm_spec("local-int8-decayK")
    jtr, tr, init, jids, ids = lm_trainers(spec)
    jh, h = jtr.run(spec.fed.rounds), tr.run(spec.fed.rounds)
    assert_counters_equal(h, jh, ids, jids, 20)
    assert h.k[:3] == [8, 7, 6] and h.k[-1] == 3
    np.testing.assert_allclose(h.train_loss, jh.train_loss, rtol=LOSS_RTOL)
    worst, mean = drift_in_steps(tr.params, jtr.params, init)
    assert worst <= 1.0 and mean <= 0.05, (worst, mean)


# Whole-run limits in int8 steps beyond TOL's atol (worst element, worst
# leaf mean) for the downlink specs over 3 rounds: the worst a third above
# the readings of ``python tests/test_torch_lm_train.py`` (int8 downlink
# 0.285, adaptive on a q8 store 0.247); both leaf means read 0 (every leaf's
# mean difference under atol / 10), held at 0.01.
DOWNLINK_DRIFT = {"local-int8-downlink": (0.38, 0.01),
                  "adaptive-downlink": (0.33, 0.01)}


def _run_spec(name, rounds):
    spec = lm_spec(name, f"fed.rounds={rounds}")
    jtr, tr, init, jids, ids = lm_trainers(spec)
    jh, h = jtr.run(rounds), tr.run(rounds)
    return h, jh, ids, jids, tr, jtr, init


@pytest.mark.parametrize("name", sorted(DOWNLINK_DRIFT))
def test_lm_downlink_specs_match_reference(name):
    """``local-int8-downlink`` (int8 both ways) and ``adaptive-downlink``
    (int8 up, adaptive down on a q8 store) for 3 rounds: counters (the
    adaptive levels' downlink charge included) and ids exact, losses
    allclose, parameters within the measured whole-run drift."""
    rounds = 3
    h, jh, ids, jids, tr, jtr, init = _run_spec(name, rounds)
    assert_counters_equal(h, jh, ids, jids, rounds)
    np.testing.assert_allclose(h.train_loss, jh.train_loss, rtol=LOSS_RTOL)
    worst, mean = drift_in_steps(tr.params, jtr.params, init)
    limit = DOWNLINK_DRIFT[name]
    assert worst <= limit[0] and mean <= limit[1], (worst, mean, limit)


@pytest.mark.parametrize("arch,moe_path", [
    ("phi3.5-moe-42b-a6.6b", "dispatch"), ("mamba2-780m", "dense")])
def test_one_lm_round_matches_reference(arch, moe_path):
    """One round of ``local-int8-decayK``'s traffic on reduced phi3.5-moe
    (dispatch path; the loss carries ``router_aux_coef`` x the aux) and on
    reduced mamba2-780m, plain uplink: counters and ids exact, losses and
    parameters allclose."""
    spec = lm_spec("local-int8-decayK", f"model.arch={arch}",
                   f"model.moe_path={moe_path}", "transport.name=none",
                   "fed.rounds=1")
    jtr, tr, init, jids, ids = lm_trainers(spec)
    jh, h = jtr.run(1), tr.run(1)
    assert_counters_equal(h, jh, ids, jids, 1)
    np.testing.assert_allclose(h.train_loss, jh.train_loss, rtol=LOSS_RTOL)
    assert_trees_close(tr.params, jtr.params, **TOL)


def test_launcher_trains_an_lm_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train_federated_lm --device cpu`` at
    a reduced size: K follows K_r-rounds, losses are finite and the
    counters add up; ``--checkpoint`` saves the final params as the
    reference's example does (bare params; rounds, arch, K-schedule in the
    meta)."""
    import json
    rounds = 3
    ckpt = str(tmp_path / "ckpt")
    h = train_federated_lm.main(["--rounds", str(rounds), "--device", "cpu",
                                 "--layers", "1", "--d-model", "64",
                                 "--vocab", "128", "--seq", "16",
                                 "--k0", "4", "--checkpoint", ckpt])
    assert h.k == [min(max(math.ceil(4 / r ** (1 / 3)), 1), 4)
                   for r in range(1, rounds + 1)]
    assert h.sgd_steps[-1] == 6 * sum(h.k)
    assert all(math.isfinite(v) for v in h.train_loss)
    with open(f"{ckpt}/meta.json") as f:
        meta = json.load(f)
    assert meta == {"rounds": rounds, "arch": "qwen2-7b-reduced",
                    "k_schedule": "rounds"}
    with np.load(f"{ckpt}/arrays.npz") as arrays:
        assert not any(k.startswith("params/") for k in arrays)
        assert arrays["embed/embedding"].shape == (128, 64)
        assert all(np.isfinite(arrays[k]).all() for k in arrays)


if __name__ == "__main__":
    # The readings the downlink drift limits are set from.
    for name in sorted(DOWNLINK_DRIFT):
        h, jh, _, _, tr, jtr, init = _run_spec(name, 3)
        worst, mean = drift_in_steps(tr.params, jtr.params, init)
        loss = np.max(np.abs(np.subtract(h.train_loss, jh.train_loss))
                      / np.abs(jh.train_loss))
        print(f"{name:22s} worst {worst:.4f} steps  mean {mean:.5f} steps  "
              f"loss rel {loss:.3e}", flush=True)
