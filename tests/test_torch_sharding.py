"""Sharded parameters (``distributed.sharding``, ``MeshBackend(param_specs=
...)``), the MoE layer's shard-local dispatch and the dry run's per-device
accounting, held against the reference.

* The rules (``param_pspecs``, ``use_2d_params``, ``fed_batch_pspecs``,
  ``serve_input_pspecs``, ``cache_pspecs``) equal the reference's exactly
  for all ten archs on the (16, 16) and (2, 16, 16) production meshes; the
  reference's side runs on ``FakeMesh`` (``tests/conftest.py``), as its own
  rule tests do. ``cache_specs`` and ``input_specs`` shapes and dtypes are
  exact.
* ``launch.dryrun``: every case's per-device param bytes equal the
  reference rules' sum; the two recorded cases of ``experiments/dryrun/``
  match their argument bytes exactly and their output bytes within 200.
* ``moe_apply_dispatch_sharded`` against the reference's at 2e-4, aux
  loss and group drops included; ``make_fed_train_step`` with
  ``moe_shards`` against the reference's shim.
* Spawned gloo ranks (rank bodies ``shard_rank_body`` in
  ``tests/test_torch_mesh_ranks.py``, no JAX): the sequential strategy with
  2d specs on 2 ranks, the parallel one with 1d specs on a (2, 2) data x
  model mesh and with ``fsdp_axes=("data", "pod")`` on a (2, 2) pod x data
  mesh, each bit for bit the same world's run without specs, with the
  rules' share of bytes a rank, the same compile counts, and a checkpoint
  that resumes in one process.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeMesh
from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.configs.shapes import SHAPES as JSHAPES
from repro.distributed import sharding as jsh
from repro.distributed import strategies as jstrat
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro_torch import bridge
from repro_torch.configs import ARCHS, SHAPES, FedConfig, get_arch
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.core.engine.backends import MeshBackend
from repro_torch.distributed import (fed_batch_specs, make_fed_train_step,
                                     make_prefill_step, sharding)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.optim import tree_leaves
from test_torch_mesh_ranks import (CKPT_AT, CKPT_RUN, SHARD_MESHES,
                                   SHARD_RUNS, dropped, femnist_setup,
                                   routing_ids, spawn, shard_rank_body)
from test_torch_parity_helpers import (TOL, _np, _torch, assert_trees_close,
                                       trees_equal)
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
MOE_TOL = dict(rtol=2e-4, atol=2e-4)             # tests/test_moe.py:33-38
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the dry run's two recorded cases: (arch, params bytes a device)
RECORDED = {"gemma2-27b__train_4k__16x16": 213_562_368,
            "qwen2-7b__train_4k__16x16": 952_335_104}


def _meshes(name):
    return FakeMesh(MESHES[name]), sharding.MeshShape(MESHES[name])


_SHAPES = {}


def _shapes(arch):
    """(reference, port) bf16 param shape trees, built once."""
    if arch not in _SHAPES:
        jcfg = JARCHS[arch]
        _SHAPES[arch] = (
            jax.eval_shape(lambda: jreg.init(jax.random.PRNGKey(0), jcfg,
                                             jnp.bfloat16)),
            treg.shapes(ARCHS[arch], torch.bfloat16))
    return _SHAPES[arch]


def _ref_specs(tree):
    """{key path: spec tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                  for p in path): tuple(s) for path, s in flat}


def _port_specs(tree):
    return {k: tuple(v) for k, v in sharding.iter_leaves(tree)}


def _ref_shapes(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                  for p in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def _port_shapes(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in sharding.iter_leaves(tree)}


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_pspecs_equal_reference(arch):
    """1d and 2d on (16, 16); 1d, 2d and 2d over ("data", "pod") on
    (2, 16, 16): leaf by leaf, key paths and entries exact; the 2d choice
    (``use_2d_params``) too."""
    jshapes, tshapes = _shapes(arch)
    jcfg, cfg = JARCHS[arch], ARCHS[arch]
    for mname in MESHES:
        fm, ms = _meshes(mname)
        layouts = [(False, ("data",)), (True, ("data",))]
        if "pod" in MESHES[mname]:
            layouts.append((True, ("data", "pod")))
        for two_d, fsdp in layouts:
            want = _ref_specs(jsh.param_pspecs(jcfg, jshapes, fm, two_d=two_d,
                                               fsdp_axes=fsdp))
            got = _port_specs(sharding.param_pspecs(cfg, tshapes, ms,
                                                    two_d=two_d,
                                                    fsdp_axes=fsdp))
            assert got == want, (mname, two_d, fsdp)
        assert sharding.use_2d_params(cfg, ms) == jsh.use_2d_params(jcfg, fm)
    assert sharding.use_2d_params(cfg, _meshes("16x16")[1]) == (
        arch in ("mixtral-8x22b", "nemotron-4-340b"))


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_batch_input_and_serve_specs_equal_reference(arch):
    """``fed_batch_pspecs`` for both strategies (the dry run's round
    geometries), ``input_specs`` of every shape kind and
    ``serve_input_pspecs`` for batches that do and do not divide."""
    jcfg, cfg = JARCHS[arch], ARCHS[arch]
    for mname in MESHES:
        fm, ms = _meshes(mname)
        for strategy, groups, n in (("parallel", None, 16),
                                    ("parallel", None, 32),
                                    ("sequential", 1, 16),
                                    ("sequential", 2, 16)):
            jb = jstrat.fed_batch_specs(jcfg, JSHAPES["train_4k"],
                                        n_clients=n, k_local=4,
                                        groups=groups)
            tb = fed_batch_specs(cfg, SHAPES["train_4k"], n_clients=n,
                                 k_local=4, groups=groups)
            want = {k: tuple(v) for k, v in
                    jsh.fed_batch_pspecs(jb, fm, strategy).items()}
            got = {k: tuple(v) for k, v in
                   sharding.fed_batch_pspecs(tb, ms, strategy).items()}
            assert got == want, (mname, strategy, groups)
        for b in (1, 16, 24, 32, 128):
            assert tuple(sharding.serve_input_pspecs(b, ms)) == \
                tuple(jsh.serve_input_pspecs(b, fm))
        assert sharding.client_axes(ms) == jsh.client_axes(fm)
    for sname in JSHAPES:
        want = jreg.input_specs(jcfg, JSHAPES[sname])
        got = treg.input_specs(cfg, SHAPES[sname])
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].shape == tuple(w.shape), (sname, k)
            assert str(got[k].dtype).replace("torch.", "") == str(w.dtype)


# every decode-cache variant the reference's cache_specs takes
CACHE_VARIANTS = [dict(), dict(ring=True), dict(long_mode=True),
                  dict(quant=True)]


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_cache_specs_and_pspecs_equal_reference(arch):
    """``cache_specs`` shapes and dtypes exact, and ``cache_pspecs`` exact,
    on both meshes, for the ring, long-mode and int8 caches, at batches
    that divide the serving axes and one that does not (B 1, the
    long_500k stream)."""
    jcfg, cfg = JARCHS[arch], ARCHS[arch]
    for kw in CACHE_VARIANTS:
        for batch, seq in ((128, 1024), (1, 4096)):
            jc = jreg.cache_specs(jcfg, batch, seq, dtype=jnp.bfloat16, **kw)
            tc = treg.cache_specs(cfg, batch, seq, torch.bfloat16, **kw)
            assert _port_shapes(tc) == _ref_shapes(jc), (kw, batch)
            assert all(t.device.type == "meta" for t in tree_leaves(tc))
            for mname in MESHES:
                fm, ms = _meshes(mname)
                assert _port_specs(sharding.cache_pspecs(cfg, tc, ms)) == \
                    _ref_specs(jsh.cache_pspecs(jcfg, jc, fm)), (kw, mname)


@pytest.mark.parametrize("arch", ["gemma2-27b", "zamba2-7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_prefill_states_have_the_cache_shapes(arch):
    """The dry run accounts a prefill's returned states as the full-length
    cache (``cache_specs``): the prefill on ``meta`` returns exactly those
    shapes and dtypes."""
    cfg = ARCHS[arch]
    tokens = torch.zeros((4, 256), dtype=torch.int32, device="meta")
    with torch.no_grad():
        _, states = make_prefill_step(cfg)(treg.shapes(cfg, torch.bfloat16),
                                           {"tokens": tokens})
    assert _port_shapes(states) == _port_shapes(
        treg.cache_specs(cfg, 4, 256, torch.bfloat16))


# ---------------------------------------------------------------------------
# the dry run's accounting
# ---------------------------------------------------------------------------

def _ref_param_bytes(arch, multi_pod):
    """The reference rules' per-device bf16 param bytes, the dry run's
    choices (``dryrun.py:66-82``)."""
    jcfg = JARCHS[arch]
    fm = FakeMesh(MESHES["2x16x16" if multi_pod else "16x16"])
    two_d = arch in dryrun.SEQUENTIAL_ARCHS
    fsdp = ("data", "pod") if (two_d and multi_pod) else ("data",)
    jshapes = _shapes(arch)[0]
    specs = jax.tree.leaves(jsh.param_pspecs(jcfg, jshapes, fm, two_d=two_d,
                                             fsdp_axes=fsdp),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(jshapes), specs):
        n = 1
        for d, e in zip(leaf.shape[len(leaf.shape) - len(spec):], spec):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= d // int(np.prod([fm.shape[a] for a in axes]))
        n *= int(np.prod(leaf.shape[:len(leaf.shape) - len(spec)]))
        total += 2 * n
    return total


def test_dryrun_accounts_every_case():
    """Every case of ``all_cases``: skipped where the reference skips,
    else the per-device param bytes equal the reference rules' sum; the
    two recorded cases hold the recorded argument bytes exactly and the
    outputs (params and the loss) within 200 bytes of XLA's."""
    want = {}
    n_ok = 0
    for arch, shape, mp in dryrun.all_cases():
        rec = dryrun.run_case(arch, shape, mp)
        if JSHAPES[shape].name == "long_500k" and \
                not JARCHS[arch].supports_long_context:
            assert rec["status"] == "skipped"
            continue
        key = (arch, mp)
        if key not in want:
            want[key] = _ref_param_bytes(arch, mp)
        assert rec["bytes_per_device"]["params"] == want[key], rec["case"]
        n_ok += 1
        if rec["case"] in RECORDED:
            assert rec["bytes_per_device"]["params"] == RECORDED[rec["case"]]
            ref = json.loads((ROOT / "experiments" / "dryrun"
                              / f"{rec['case']}.json").read_text())
            mem = ref["memory_analysis"]
            assert rec["argument_bytes"] == mem["argument_size_in_bytes"]
            assert 0 <= mem["output_size_in_bytes"] - rec["output_bytes"] \
                <= 200
            for k in ("strategy", "two_d_params", "param_count",
                      "n_clients", "k_local", "tokens_per_round"):
                assert rec[k] == ref[k], k
    assert n_ok >= 60


def test_dryrun_cli_and_production_mesh(capsys):
    assert dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k",
                        "--multi-pod"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert set(rec["bytes_per_device"]) == {"params", "cache", "token",
                                            "pos"}
    for mp, (shape, names) in ((False, ((16, 16), ("data", "model"))),
                               (True, ((2, 16, 16),
                                       ("pod", "data", "model")))):
        m = make_production_mesh(multi_pod=mp)
        assert tuple(m.shape.values()) == shape and m.axis_names == names


# ---------------------------------------------------------------------------
# the MoE layer's shard-local dispatch
# ---------------------------------------------------------------------------

_MOE = {}


def _moe_layer(name, cf=None):
    """One reduced MoE layer's params (both packages) and a (2, 32, d)
    input; ``cf`` a capacity factor."""
    if name not in _MOE:
        jcfg = jget_arch(name)
        jp = jax.jit(lambda k: jreg.init(k, jcfg))(jax.random.PRNGKey(0))
        lp = jax.tree.map(lambda a: np.asarray(a)[0],
                          jp["stack"]["b0"]["moe"])
        _MOE[name] = (jcfg, lp)
    jcfg, lp = _MOE[name]
    cfg = get_arch(name)
    if cf is not None:
        import dataclasses
        rep = lambda c: dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf))
        jcfg, cfg = rep(jcfg), rep(cfg)
    x = (np.random.default_rng(1).normal(size=(2, 32, cfg.d_model))
         .astype(np.float32))
    return cfg, jcfg, bridge.params_from_jax(lp, device="cpu"), lp, x


@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b-reduced",
                                  "mixtral-8x22b-reduced"])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("cf", [None, 0.5])
def test_dispatch_sharded_matches_reference(name, shards, cf):
    """``moe_apply(path="dispatch_sharded", shards=)`` (stacked groups,
    plain and through ``ops.moe_gmm``'s plain version) against the
    reference's at 2e-4, aux loss included; at capacity factor 0.5 the
    groups drop assignments. The stacked dispatch equals the per-group
    loop."""
    cfg, jcfg, tp, jp, x = _moe_layer(name, cf)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, jp), jcfg,
                              jnp.asarray(x), path="dispatch_sharded",
                              shards=shards)
    with routing_ids() as ids:
        ty, taux = tmoe.moe_apply(tp, cfg, torch.tensor(x),
                                  path="dispatch_sharded", shards=shards)
    cap = tmoe.capacity(cfg, x.shape[0] * x.shape[1] // shards)
    drops = dropped(ids[0], shards, cap, cfg.moe.num_experts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (drops > 0) == (cf is not None)
    ky, kaux = tmoe.moe_apply(tp, cfg, torch.tensor(x),
                              path="dispatch_sharded", shards=shards,
                              use_kernel=True)
    np.testing.assert_allclose(ky.numpy(), np.asarray(jy), **MOE_TOL)
    ly, laux = tmoe.moe_apply_dispatch_sharded(
        tp, cfg, torch.tensor(x), shards=shards, stacked=False)
    assert torch.equal(ly, ty) and torch.equal(laux, taux)


def test_fed_train_step_moe_shards_matches_reference_shim():
    """Reduced phi3.5-moe, one parallel round through
    ``make_fed_train_step(moe_path="dispatch_sharded", moe_shards=2)``
    against the reference's shim."""
    jcfg = jget_arch("phi3.5-moe-42b-a6.6b").reduced()
    params = _np(jreg.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    batches = {"tokens": rng.integers(0, jcfg.vocab_size, (4, 2, 2, 16),
                                      dtype=np.int32)}
    w = np.full((4,), 0.25, np.float32)
    kw = dict(remat=False, moe_path="dispatch_sharded", moe_shards=2)
    jstep = jstrat.make_fed_train_step(jcfg, **kw)
    jp, jl = jax.jit(jstep)(jax.tree.map(jnp.asarray, params),
                            {k: jnp.asarray(v) for k, v in batches.items()},
                            jnp.asarray(w), jnp.float32(0.05))
    step = make_fed_train_step(get_arch("phi3.5-moe-42b-a6.6b-reduced"),
                               device="cpu", **kw)
    p, loss = step(_torch(params), batches, w, 0.05)
    assert_trees_close(p, jp, **TOL)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)


def test_tensor_parallel_arguments_refused_by_name():
    """The train step takes ``act_spec``, ``attn_kv_spec`` and
    ``moe_spmd_axes`` over several ranks (tensor-parallel training, A15
    (b)): on a (1, 4) mesh the step is built; a spec the layout cannot
    place is refused by name, as are client axes other than the
    backend's. On one device the specs change no value, in the train step
    and the prefill alike."""
    cfg = get_arch("phi3.5-moe-42b-a6.6b-reduced")
    for kw in (dict(act_spec=("data", "model", None)),
               dict(attn_kv_spec=("data", "model", None, None))):
        make_fed_train_step(cfg, device="cpu", **kw)
        make_prefill_step(cfg, **kw)

    class Mesh:                       # a DeviceMesh's names and sizes
        mesh_dim_names = ("data", "model")
        device_type = "cpu"

        @staticmethod
        def size(i):
            return (1, 4)[i]

    # the specs are read against the mesh before any collective
    moe = dict(moe_path="dispatch_sharded", moe_shards=2)
    make_fed_train_step(cfg, mesh=Mesh(), moe_spmd_axes=("model",),
                        act_spec=(None, "model", None), **moe)
    for bad, match in ((dict(moe_spmd_axes=("data",)),
                        "spread over the 'model' ranks"),
                       (dict(act_spec=("model", None, None)),
                        "'model' on the batch dim"),
                       (dict(act_spec=("data", "model", None)),
                        "parallel strategy splits a client's batch")):
        with pytest.raises(ValueError, match=match):
            make_fed_train_step(cfg, mesh=Mesh(), **bad, **moe)
    make_fed_train_step(cfg, device="cpu", moe_spmd_axes=("model",),
                        moe_path="dispatch_sharded", moe_shards=2,
                        client_spmd_axes=("data",))
    with pytest.raises(ValueError, match="client_spmd_axes"):
        make_fed_train_step(cfg, device="cpu",
                            client_spmd_axes=("model",))(
            None, {"tokens": np.zeros((1, 1, 1, 4), np.int32)},
            np.ones(1, np.float32), 0.1)


def test_param_layout_refuses_what_it_cannot_place():
    """``ParamLayout`` tells a whole leaf from this rank's block by its
    trailing dims (flattened: its size) and refuses a leaf of neither
    shape; its map passes what is not params-shaped (a step count, a
    batch) and refuses a tree that shares only some of the params' keys,
    or a container where a param leaf belongs."""
    from repro_torch.core.engine.backends.mesh import ParamLayout
    specs = {"w": sharding.PSpec(None, "model"), "b": sharding.PSpec(None)}
    lay = ParamLayout(specs, sharding.MeshShape({"data": 1, "model": 2}))
    lay.learn({"w": torch.zeros(4, 6), "b": torch.zeros(6)})
    assert lay.block_shapes == [(4, 3), (6,)]
    assert lay.is_whole(0, torch.zeros(4, 6))
    assert lay.is_whole(0, torch.zeros(5, 4, 6))        # per-client slots
    assert not lay.is_whole(0, torch.zeros(5, 4, 3))
    assert lay.is_whole(1, torch.zeros(6))              # nothing split
    with pytest.raises(ValueError, match="neither the whole leaf"):
        lay.is_whole(0, torch.zeros(4, 5))
    assert lay.is_whole_flat(0, torch.zeros(24))
    assert not lay.is_whole_flat(0, torch.zeros(12))
    with pytest.raises(ValueError, match="neither the whole leaf"):
        lay.is_whole_flat(0, torch.zeros(10))
    seen = []
    tree = {"m": {"w": torch.zeros(4, 6), "b": torch.zeros(6)},
            "t": torch.zeros(()), "batch": {"x": torch.zeros(2)}}
    out = lay.map(tree, lambda i, x: seen.append(i) or x, None)
    assert seen == [0, 1] and out["t"] is tree["t"] and \
        out["batch"]["x"] is tree["batch"]["x"]
    with pytest.raises(ValueError, match="params-shaped tree"):
        lay.map({"w": torch.zeros(4, 6)}, lambda i, x: x, None)
    with pytest.raises(ValueError, match="where param leaf 0 belongs"):
        lay.map({"w": [torch.zeros(4, 6)], "b": torch.zeros(6)},
                lambda i, x: x, None)


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_ranks(tmp_path_factory):
    out = {}
    for name, (world, *_rest) in SHARD_MESHES.items():
        tmp = tmp_path_factory.mktemp(name)
        out[name] = spawn(shard_rank_body, world, tmp, name, str(tmp))
    return out


def _placed_share(specs, mesh_name):
    _, shape, names, *_ = SHARD_MESHES[mesh_name]
    _, _, params, _ = femnist_setup()
    return sharding.block_bytes(params, specs,
                                sharding.MeshShape(shape, names))


@pytest.mark.parametrize("mesh_name", sorted(SHARD_MESHES))
@pytest.mark.parametrize("run", sorted(SHARD_RUNS))
def test_sharded_runs_equal_unsharded_bitwise(shard_ranks, mesh_name, run):
    """Every rank: params (whole, as ``trainer.params`` reads them),
    losses, counters, codec and server state bit for bit the same world's
    run without ``param_specs``; compile, shared and dispatch counts
    equal; the params and server state at rest are exactly the rules'
    share of bytes; the ranks' params alike."""
    results = shard_ranks[mesh_name]
    for res in results:
        plain, shard = res[f"plain.{run}"], res[f"sharded.{run}"]
        assert trees_equal(shard["params"], plain["params"]), res["rank"]
        hp, hs = plain["history"], shard["history"]
        assert (hs.train_loss, hs.k, hs.uplink_mbit, hs.downlink_mbit) == \
            (hp.train_loss, hp.k, hp.uplink_mbit, hp.downlink_mbit)
        for key in ("t_state", "d_state", "server"):
            a, b = tree_leaves(shard[key]), tree_leaves(plain[key])
            assert len(a) == len(b)
            assert all(torch.equal(x, y) for x, y in zip(a, b)
                       if isinstance(x, torch.Tensor)), key
        assert shard["counts"] == plain["counts"]
        share = _placed_share(res["specs"], mesh_name)
        assert shard["params_bytes"] == share < plain["params_bytes"]
        if SHARD_RUNS[run].get("server_optimizer") == "fedavgm":
            assert shard["server_bytes"] == share
        assert trees_equal(res[f"sharded.{run}"]["params"],
                           results[0][f"sharded.{run}"]["params"])


@pytest.mark.parametrize("mesh_name", sorted(SHARD_MESHES))
def test_block_of_and_gather_leaf_hold_a_hand_built_layout(shard_ranks,
                                                          mesh_name):
    """A dim over ("data", "pod") takes "data" as major; blocks and the
    gather agree with slices cut by hand on every rank."""
    for res in shard_ranks[mesh_name]:
        lay = res["layout"]
        assert torch.equal(lay["block"], lay["want"])
        assert torch.equal(lay["gathered"], lay["x"])


def test_sharded_lm_sequential_equals_unsharded(shard_ranks):
    """Reduced qwen1.5-0.5b (``mesh-sequential-cosine.json``, int8 both
    ways) on the sequential strategy with 2d specs over 2 data ranks:
    bitwise the unsharded run, the rules' share of param bytes."""
    for res in shard_ranks["seq2d"]:
        plain, shard = res["plain.lm"], res["sharded.lm"]
        assert trees_equal(shard["params"], plain["params"])
        assert shard["history"].train_loss == plain["history"].train_loss
        assert shard["counts"] == plain["counts"]
        cfg = get_arch("qwen1.5-0.5b-reduced")
        share = sharding.block_bytes(treg.shapes(cfg), res["lm_specs"],
                                     sharding.MeshShape((2, 1),
                                                        ("data", "model")))
        assert shard["params_bytes"] == share < plain["params_bytes"]


def _one_rank_trainer(rounds):
    task, data, params, loss_fn = femnist_setup()
    fed = FedConfig(total_clients=8, clients_per_round=4, rounds=rounds,
                    k0=3, eta0=0.3, batch_size=4, k_schedule="rounds",
                    seed=0, **CKPT_RUN)
    return FedAvgTrainer(loss_fn, params, data, fed,
                         RuntimeModel(task.model_size_mb, task.runtime, 4),
                         device="cpu", backend=MeshBackend(
                             None, strategy="sequential", groups=2,
                             device="cpu"))


def test_sharded_checkpoint_resumes_in_one_rank(shard_ranks):
    """The 2-rank sharded run's checkpoint (after 2 rounds; int8 both ways
    on a q8 store, fedavgm) holds the same arrays as the unsharded run's,
    and restored into a one-process run continues bit for bit as the
    unsharded checkpoint does."""
    res = shard_ranks["seq2d"][0]
    load = lambda p: dict(np.load(Path(p) / "arrays.npz"))
    a, b = load(res["ckpt.sharded"]), load(res["ckpt.plain"])
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    runs = []
    for tag in ("sharded", "plain"):
        tr = _one_rank_trainer(CKPT_AT + 2)
        tr.restore_state(res[f"ckpt.{tag}"])
        h = tr.run(CKPT_AT + 2, resume=True)
        runs.append((tr.params, h.train_loss))
    assert trees_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1] and len(runs[0][1]) == CKPT_AT + 2
