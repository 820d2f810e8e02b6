"""Serving while training on the port against the reference
(``tests/test_serve.py``), on the CPU: the store's snapshot contract across
the downlink and ref-store pairs on both backends, the async engine's
mid-buffer snapshot, the read-only rule, checkpoints with the serve
counters, the scheduler's serve cuts, the runtime model's serve stretch,
the spec's validation, the synthetic traffic, the serve launcher, and
``examples/specs/serve-while-training.json`` through both packages'
``build``."""
import json
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.api import ExperimentSpec as JSpec
from repro.api import build as jbuild
from repro.api.spec import SpecValidationError as JSpecError
from repro.configs.base import FedConfig as JFed
from repro.configs.base import RuntimeModelConfig as JRtCfg
from repro.core import RuntimeModel as JRuntime
from repro.core.engine.scheduler import RoundScheduler as JScheduler
from repro.core.schedules import DecayController as JCtrl
from repro_torch.api import ExperimentSpec, FederatedExperiment, build
from repro_torch.api.spec import SpecValidationError
from repro_torch.configs.base import FedConfig, RuntimeModelConfig
from repro_torch.core import RuntimeModel
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.engine.scheduler import RoundScheduler
from repro_torch.core.schedules import DecayController
from repro_torch.optim import tree_leaves, tree_map
from test_torch_parity_helpers import (drift_in_steps, flat, lm_spec,
                                       record_ids, trees_equal)
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

PAPER = ("data.kind=paper", "data.task=femnist", "data.clients=16",
         "data.samples_per_client=16", "fed.clients_per_round=6",
         "fed.rounds=4", "fed.k0=3", "fed.batch_size=8",
         "fed.k_schedule=rounds", "fed.bucket_rounds=2", "fed.eval_every=0")

LM = ("model.arch=qwen1.5-0.5b", "model.reduced=true", "data.kind=lm",
      "data.clients=8", "data.samples_per_client=8", "data.seq_len=16",
      "fed.rounds=3", "fed.clients_per_round=4", "fed.k0=2",
      "fed.batch_size=4", "fed.k_schedule=rounds", "fed.bucket_rounds=2",
      "runtime.beta_seconds=0.05")

SPEC = "serve-while-training"
# the downlink and ref-store pairs of the snapshot contract
PAIRS = [("none", "f32"), ("int8", "f32"), ("int8", "q8"),
         ("adaptive", "f32"), ("adaptive", "q8")]
LOSS_RTOL = 1e-4


def paper_spec(*extra):
    return ExperimentSpec().with_overrides(*PAPER, *extra)


def lm(*extra):
    return ExperimentSpec().with_overrides(*LM, *extra)


def _bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and trees_equal(a, b)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process, for the module
    (``backend.name=mesh`` builds its mesh over it)."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the snapshot contract: the tree clients hold, across the store bracket
# ---------------------------------------------------------------------------

def _snapshot_run(backend, downlink, ref_store):
    exp = build(paper_spec(f"backend.name={backend}",
                           "transport.name=int8",
                           f"transport.downlink={downlink}",
                           f"transport.ref_store={ref_store}"), device="cpu")
    exp.run()
    return exp.trainer


@pytest.mark.parametrize("backend", ["local", "mesh"])
@pytest.mark.parametrize("downlink,ref_store", PAIRS)
def test_snapshot_matches_client_tree(world1, backend, downlink, ref_store):
    """``snapshot()`` returns (version, the tree clients hold): the params
    without a downlink codec, else the codec's ``load_tree`` of the stored
    reference; bitwise, repeatably, and without writing any server state.
    The mesh at one rank gives the local run's snapshot bit for bit
    (Known difference C7)."""
    tr = _snapshot_run(backend, downlink, ref_store)
    store = tr.store
    assert store.version == 4                    # one bump a round
    v, tree = store.snapshot()
    assert v == store.version
    if downlink == "none":
        assert tree is tr.params
    else:
        state = tr.engine.downlink_state
        before = [t.clone() for t in tree_leaves(state["ref"])]
        dl = tr.engine.downlink
        assert _bitwise(tree, dl.load_tree(state["ref"], like=tr.params))
        if ref_store == "f32":
            assert _bitwise(tree, state["ref"])
        assert all(torch.equal(a, b) for a, b in
                   zip(before, tree_leaves(state["ref"])))
    v2, tree2 = store.snapshot()
    assert v2 == v and _bitwise(tree2, tree)
    if backend == "mesh":
        local = _snapshot_run("local", downlink, ref_store)
        assert _bitwise(tree, local.store.snapshot()[1])
        assert _bitwise(tr.params, local.params)


def test_async_snapshot_mid_buffer():
    """The async engine mid-simulation (a part-filled buffer, events in
    flight): the snapshot is the applied params bitwise, at the version of
    the applications so far."""
    exp = build(paper_spec("fed.rounds=8", "fed.aggregation=async",
                           "fed.buffer_size=3", "fed.staleness_weight=inv",
                           "runtime.heterogeneity=0.7"), device="cpu")
    exp.trainer.run(5)
    tr = exp.trainer
    assert tr._buf_count != 0 or tr._heap
    v, tree = tr.store.snapshot()
    assert v == tr.store.version == tr._version == 5
    assert tree is tr.params


# ---------------------------------------------------------------------------
# the read-only rule
# ---------------------------------------------------------------------------

def _watch_ticks(trainer):
    """Clone the served tree at every tick, and check at the next tick
    (before its swap) that the served tree still holds those values: the
    trainer never writes the tree under the service."""
    loop, held = trainer.serving, []
    tick = loop.tick

    def watched(r, history=None):
        if held:
            assert _bitwise(loop.params, held[-1]), f"tick {r}"
        out = tick(r, history)
        held.append(tree_map(torch.clone, loop.params))
        return out

    loop.tick = watched
    return held


@pytest.mark.parametrize("serve", [("serve.every=1",),
                                   ("serve.every=2", "serve.qps=50.0",
                                    "serve.query_ms=2.0")],
                         ids=["every1", "every2-qps50"])
def test_serving_read_only_program_identity(serve):
    """Attaching the serving loop changes nothing the trainer computes:
    the same program key, params bit for bit, losses, steps and wire
    charges equal to the serve-off run; the wall clock is the serve-off
    round's times the stretch 1/(1 - rho). ``serve.every`` cuts the bucket
    plan, so both sides pin ``fed.bucket_rounds=1``. The served tree is
    never written under the service, and the last tick serves the version
    of its round."""
    from repro_torch.api.sweep import spec_program_key
    off = lm("fed.bucket_rounds=1")
    on = lm("fed.bucket_rounds=1", *serve)
    assert spec_program_key(off) == spec_program_key(on)
    exp_off, exp_on = build(off, device="cpu"), build(on, device="cpu")
    h_off = exp_off.run()
    held = _watch_ticks(exp_on.trainer)
    h_on = exp_on.run()
    assert _bitwise(exp_on.params, exp_off.params)
    assert h_on.train_loss == h_off.train_loss
    assert h_on.sgd_steps == h_off.sgd_steps
    assert h_on.uplink_mbit == h_off.uplink_mbit
    rho = on.serve.qps * on.serve.query_ms / 1e3
    np.testing.assert_allclose(np.diff(h_on.wall_clock_s, prepend=0.0),
                               np.diff(h_off.wall_clock_s, prepend=0.0)
                               / (1.0 - rho), rtol=1e-12, atol=0)
    every = on.serve.every
    assert h_on.serve_rounds == [r for r in (1, 2, 3) if r % every == 0]
    assert len(held) == len(h_on.serve_rounds)
    assert all(t > 0 for t in h_on.serve_tokens_per_sec)
    assert h_on.serve_staleness == [every] * len(h_on.serve_rounds)
    loop = exp_on.trainer.serving
    assert exp_on.trainer.store.version == 3
    assert loop.served_version == 3 - 3 % every
    assert exp_on.trainer.store.serve_queries == pytest.approx(
        on.serve.qps * h_on.wall_clock_s[-1], rel=1e-12)
    assert h_off.serve_rounds == [] and exp_off.trainer.serving is None


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aggregation", ["sync", "async"])
def test_legacy_checkpoint_restores_bitwise(tmp_path, aggregation):
    """A checkpoint without the store's meta keys (``store_version``,
    ``serve_queries``) restores and continues bitwise."""
    extra = (("transport.name=int8", "transport.downlink=int8",
              "transport.ref_store=q8") if aggregation == "sync" else
             ("fed.aggregation=async", "fed.buffer_size=3",
              "runtime.heterogeneity=0.7", "fed.rounds=8"))
    spec = paper_spec(*extra)
    rounds = spec.fed.rounds
    ref = build(spec, device="cpu")
    href = ref.run()
    a = build(spec, device="cpu")
    a.trainer.run(rounds // 2)
    ck = os.path.join(tmp_path, "ck")
    a.save(ck)
    meta_path = os.path.join(ck, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert "store_version" in meta
    for k in ("store_version", "serve_queries"):
        meta.pop(k, None)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    b = FederatedExperiment.restore(ck, device="cpu")
    hb = b.trainer.run(rounds, resume=True)
    assert hb.train_loss == href.train_loss
    assert hb.wall_clock_s == href.wall_clock_s
    assert hb.uplink_mbit == href.uplink_mbit
    assert _bitwise(b.trainer.params, ref.trainer.params)
    assert b.trainer.store.version > 0


def test_checkpoint_roundtrip_keeps_serve_counters(tmp_path):
    """A serving run's checkpoint keeps every store counter, serve_queries
    included, and the history's serve series; the restored run re-swaps
    its loop to the restored version and continues as the uninterrupted
    run (ticks, staleness and serve_queries)."""
    spec = lm("fed.rounds=4", "serve.every=2", "serve.qps=50.0",
              "serve.query_ms=2.0")
    full = build(spec, device="cpu")
    hf = full.run()
    a = build(spec, device="cpu")
    a.trainer.run(2)
    assert a.trainer.store.serve_queries > 0
    ck = os.path.join(tmp_path, "ck")
    a.save(ck)
    b = FederatedExperiment.restore(ck, device="cpu")
    for attr in ("version", "wall", "steps", "up_mbit", "down_mbit",
                 "min_loss", "max_acc", "serve_queries"):
        assert getattr(b.trainer.store, attr) == \
            getattr(a.trainer.store, attr), attr
    assert b.history.serve_rounds == a.history.serve_rounds == [2]
    assert b.history.serve_staleness == a.history.serve_staleness
    assert _bitwise(b.trainer.params, a.trainer.params)
    hb = b.trainer.run(4, resume=True)
    assert b.trainer.serving.served_version == 4
    assert hb.serve_rounds == hf.serve_rounds == [2, 4]
    assert hb.serve_staleness == hf.serve_staleness
    assert b.trainer.store.serve_queries == full.trainer.store.serve_queries
    assert _bitwise(b.trainer.params, full.trainer.params)


# ---------------------------------------------------------------------------
# scheduler, runtime model, spec, traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("every", [None, 2, 3])
def test_scheduler_serve_cuts_and_flags(every):
    """Buckets cut at serve rounds and flagged, as the reference's plan."""
    kw = dict(total_clients=8, clients_per_round=4, rounds=8, k0=4,
              eta0=0.1, batch_size=4, k_schedule="fixed", bucket_rounds=8,
              seed=0)
    plans = []
    for Fed, Ctrl, Sched in ((FedConfig, DecayController, RoundScheduler),
                             (JFed, JCtrl, JScheduler)):
        fed = Fed(**kw)
        plans.append([(b.rounds, b.serve_after) for b in Sched(
            Ctrl(fed), fed, total_rounds=8, serve_every=every).plan()])
    assert plans[0] == plans[1]
    assert all(flag == (every is not None and rounds[-1] % every == 0)
               for rounds, flag in plans[0])


@pytest.mark.parametrize("het", [0.0, 0.5])
def test_runtime_model_serve_stretch_matches_reference(het):
    """Every round's cost, serve_queries included, exactly the
    reference's over a grid of qps and query seconds; rho >= 1 raises the
    reference's message."""
    for qps in (0.0, 1.0, 50.0, 100.0, 333.0):
        for q_s in (0.0005, 0.002, 0.0029):
            if qps * q_s >= 1.0:
                continue
            kw = dict(model_size_mbit=40.0, clients_per_round=4,
                      heterogeneity=het, seed=3, serve_qps=qps,
                      serve_query_s=q_s)
            got = RuntimeModel(cfg=RuntimeModelConfig(beta_seconds=0.5),
                               **kw)
            want = JRuntime(cfg=JRtCfg(beta_seconds=0.5), **kw)
            for k in (8, 5, 1):
                a, b = got.round_cost(k), want.round_cost(k)
                assert (a.wall_clock_s, a.sgd_steps, a.uplink_mbit,
                        a.downlink_mbit, a.serve_queries) == (
                    b.wall_clock_s, b.sgd_steps, b.uplink_mbit,
                    b.downlink_mbit, b.serve_queries)
    base = RuntimeModel(40.0, RuntimeModelConfig(beta_seconds=0.5), 4)
    assert base.round_cost(8).serve_queries == 0.0
    msgs = []
    for Rt, Cfg in ((RuntimeModel, RuntimeModelConfig), (JRuntime, JRtCfg)):
        with pytest.raises(ValueError, match="rho") as e:
            Rt(40.0, Cfg(beta_seconds=0.5), 4, serve_qps=500.0,
               serve_query_s=0.002)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


SERVE_ERRORS = [("serve.every=-1",), ("serve.qps=1.0",),
                ("serve.every=1", "serve.qps=600.0", "serve.query_ms=2.0"),
                ("serve.every=1", "serve.traffic=nope"),
                ("serve.every=1", "serve.batch=0"),
                ("serve.every=1", "serve.query_ms=0"),
                ("serve.every=1", "data.kind=paper")]


@pytest.mark.parametrize("overrides", SERVE_ERRORS,
                         ids=lambda ov: "|".join(ov))
def test_serve_spec_validation_errors_match_reference(overrides):
    def errs(Spec, Err):
        with pytest.raises(Err) as ei:
            Spec().with_overrides(*LM, *overrides).validate()
        return [m.replace("repro_torch.", "repro.") for m in ei.value.errors]

    assert errs(ExperimentSpec, SpecValidationError) == errs(JSpec,
                                                             JSpecError)
    lm().validate()
    lm("serve.every=2", "serve.qps=50.0", "serve.query_ms=2.0").validate()


def test_traffic_registry_synthetic_matches_reference():
    from repro.api.registries import TRAFFIC_REGISTRY as JTRAFFIC
    from repro_torch.api.registries import TRAFFIC_REGISTRY

    class Cfg:
        vocab_size = 97
    assert "synthetic" in TRAFFIC_REGISTRY
    for seed in (11, 12):
        t = TRAFFIC_REGISTRY.get("synthetic")(cfg=Cfg(), batch=3,
                                              prompt_len=5, seed=seed)
        j = JTRAFFIC.get("synthetic")(cfg=Cfg(), batch=3, prompt_len=5,
                                      seed=seed)
        for tick in range(4):
            a = t(tick)
            assert a.shape == (3, 5) and a.dtype == np.int32
            np.testing.assert_array_equal(a, j(tick))
            np.testing.assert_array_equal(a, t(tick))
    assert not (t(4) == t(5)).all()


def test_store_standalone_snapshot():
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    store = GlobalModelStore(params=params)
    v, tree = store.snapshot()
    assert v == 0 and tree is params
    store.advance(3)
    assert store.snapshot()[0] == 3


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_serve_launcher_rebuilds_from_embedded_spec(tmp_path, capsys):
    from repro_torch.launch import serve as serve_launcher
    exp = build(lm("serve.every=1"), device="cpu")
    exp.run()
    ck = os.path.join(tmp_path, "ck")
    exp.save(ck)
    serve_launcher.main(["--checkpoint", ck, "--batch", "2", "--prompt-len",
                         "4", "--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "rebuilt qwen1.5-0.5b" in out and "tok/s" in out
    with pytest.raises(SystemExit, match="conflicts with the"):
        serve_launcher.main(["--checkpoint", ck, "--arch", "zamba2-7b",
                             "--device", "cpu"])
    cfg, params = serve_launcher.load_serving_params(ck, device="cpu")
    assert _bitwise(params, exp.trainer.params)
    assert cfg.name == "qwen1.5-0.5b-reduced"


def test_train_launcher_prints_the_serve_line(capsys):
    from repro_torch.launch import train
    spec = os.path.join(os.path.dirname(__file__), "..", "examples", "specs",
                        f"{SPEC}.json")
    exp = train.main(["--spec", spec, "--set", "fed.rounds=4", "--device",
                      "cpu"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[train] serve: "))
    assert line.startswith("[train] serve: 2 tick(s), ")
    assert "staleness <= 2, served version 4 of 4" in line
    assert exp.history.serve_rounds == [2, 4]


# ---------------------------------------------------------------------------
# the spec against the reference, and the async engine's ticks
# ---------------------------------------------------------------------------

def test_serve_while_training_spec_matches_reference(tmp_path):
    """``serve-while-training.json`` (reduced qwen1.5-0.5b, int8 both ways
    on a q8 store, a tick every 2 rounds at 50 qps x 2 ms) for its 6
    rounds. The reference ``build``s it and saves at round 0; the port's
    ``FederatedExperiment.restore`` of that checkpoint (its ``build`` of
    the embedded spec, with the reference's initial state) runs the same
    rounds. K_r, client ids, sgd_steps, the stretched wall clock, both
    wire charges, serve_queries, the tick rounds and their staleness
    exact; losses allclose; params within one int8 step of each leaf's
    movement (the rule of the whole-run LM tests)."""
    jexp = jbuild(lm_spec(SPEC))
    ck = str(tmp_path / "r0")
    jexp.save(ck)
    with np.load(os.path.join(ck, "arrays.npz")) as data:
        init = {k[len("params/"):]: data[k] for k in data
                if k.startswith("params/")}
    jids = record_ids(jexp.trainer)
    jh = jexp.run()
    exp = FederatedExperiment.restore(ck, device="cpu")
    assert exp.trainer.serving is not None and exp.trainer.serve_every == 2
    ids = record_ids(exp.trainer)
    h = exp.trainer.run(6, resume=True)
    assert ids == jids and len(ids) == 6
    for key in ("rounds", "k", "eta", "sgd_steps", "wall_clock_s",
                "uplink_mbit", "downlink_mbit", "serve_rounds",
                "serve_staleness"):
        assert getattr(h, key) == getattr(jh, key), key
    assert h.serve_rounds == [2, 4, 6] and h.serve_staleness == [2, 2, 2]
    st, jst = exp.trainer.store, jexp.trainer.store
    assert st.serve_queries == jst.serve_queries
    assert st.version == jst.version == 6
    assert exp.trainer.serving.served_version == 6
    np.testing.assert_allclose(h.train_loss, jh.train_loss, rtol=LOSS_RTOL)
    want = jax.tree.map(np.asarray, jexp.trainer.params)
    got = {k.rstrip("/"): v for k, v in flat(exp.params).items()}
    worst, mean = drift_in_steps(got, {k.rstrip("/"): v for k, v in
                                       flat(want).items()}, init)
    assert worst <= 1.0 and mean <= 0.05, (worst, mean)
    # the served model is the tree clients hold: the q8 store's load
    tr = exp.trainer
    ref = tr.engine.downlink_state["ref"]
    assert _bitwise(tr.serving.params,
                    tr.engine.downlink.load_tree(ref, like=tr.params))


ASYNC_SERVE = ("fed.aggregation=async", "fed.buffer_size=2",
               "fed.rounds=6", "runtime.heterogeneity=0.5", "serve.every=2",
               "serve.qps=20.0", "serve.query_ms=2.0")


def test_async_serving_ticks_match_reference():
    """The async engine ticks after every ``serve.every``-th buffer
    application: tick rounds, staleness, the event-clock wall and the
    applied and dropped counts equal the reference's (the event trace
    depends on K_r and the seeded client times, not on the params)."""
    spec = lm(*ASYNC_SERVE)
    exp = build(spec, device="cpu")
    jexp = jbuild(JSpec().with_overrides(*LM, *ASYNC_SERVE))
    h, jh = exp.run(), jexp.run()
    for key in ("rounds", "k", "wall_clock_s", "sgd_steps", "staleness",
                "applied_updates", "dropped_updates", "serve_rounds",
                "serve_staleness"):
        assert getattr(h, key) == getattr(jh, key), key
    assert h.serve_rounds == [2, 4, 6]
    assert exp.trainer.serving.served_version == exp.trainer.store.version
