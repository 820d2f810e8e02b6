"""The bucket program registry and whole-bucket dispatch in the port
(``core.engine.round``), against the reference (``tests/test_backends.py``'s
``test_compile_registry_counts_exactly``, ``tests/test_engine.py`` and
``tests/test_fleet.py::TestRegistrySharing``).

Across the two packages: the compile, shared and dispatch counts are equal
on the same runs, and bucket outputs and histories agree at the f32
tolerance. Inside the port: a bucket of B rounds is bitwise B one-round
buckets, and padding rounds leave every state bitwise untouched."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.api import ExperimentSpec as JSpec
from repro.api import build as jbuild
from repro.api.sweep import spec_program_key as jspec_program_key
from repro.configs import FedConfig as JFed
from repro.core import FedAvgTrainer as JTrainer
from repro.core import RuntimeModel as JRuntime
from repro.core.engine.round import ExecutableRegistry as JRegistry
from repro.core.engine.round import RoundEngine as JEngine
from repro.models import small as jsmall
from repro_torch.api import ExperimentSpec, build
from repro_torch.api.sweep import spec_program_key
from repro_torch.configs import FedConfig, get_paper_task
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.core.engine.round import (BucketProgram, ExecutableRegistry,
                                           RoundEngine)
from repro_torch.core.mem import executable_peak_bytes, executable_peak_mb
from repro_torch.data import pipeline
from repro_torch.models import small
from test_torch_parity_helpers import (_torch, assert_trees_close,
                                       small_setup)
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

# tests/test_kernels.py's f32 tolerance, for outputs across frameworks; the
# cross-framework runs train at eta 0.05, as tests/test_torch_checkpoint.py
# does (ROADMAP Known differences 11: at 0.3 the float drift outgrows it)
KTOL = dict(rtol=2e-4, atol=2e-4)
ETA = 0.05
HISTORY_EXACT = ("rounds", "k", "eta", "sgd_steps", "wall_clock_s",
                 "uplink_mbit", "downlink_mbit")


def _base(**kw):
    """tests/test_fleet.py's base spec, in either package."""
    ov = ["data.kind=paper", "data.task=femnist", "data.clients=8",
          "data.samples_per_client=8", "fed.clients_per_round=4",
          "fed.rounds=2", "fed.batch_size=4", "fed.bucket_rounds=2",
          "fed.eta0=0.3"]
    ov += [f"{k}={v}" for k, v in kw.items()]
    return ov


def port_spec(**kw):
    return ExperimentSpec().with_overrides(*_base(**kw))


def ref_spec(**kw):
    return JSpec().with_overrides(*_base(**kw))


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for k in x for leaf in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _bytes(x):
    return x.detach().reshape(-1).view(torch.uint8)


def bitwise(a, b) -> bool:
    """Every leaf the same bytes (NaNs included); None leaves on both
    sides."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x is y is None or (x is not None and y is not None
                           and x.dtype == y.dtype and x.shape == y.shape
                           and torch.equal(_bytes(x), _bytes(y)))
        for x, y in zip(la, lb))


def femnist():
    task, params, data = small_setup("femnist")
    ttask = get_paper_task("femnist")
    return (task, params, data,
            lambda p, b: jsmall.task_loss(p, task, b),
            lambda p, b: small.task_loss(p, ttask, b))


# ---------------------------------------------------------------------------
# counts and outputs against the reference
# ---------------------------------------------------------------------------

def test_compile_registry_counts_exactly():
    """The reference's sequence of buckets (2, 3), (2, 3), (4, 3), (2, 2):
    the repeat reuses its program, so 3 built and 4 dispatched in both
    packages, every bucket's losses and params within the f32
    tolerance."""
    task, params, data, jloss, tloss = femnist()
    jeng, teng = JEngine(jloss), RoundEngine(tloss, device="cpu")
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jeng.init_server_state(jp), teng.init_server_state(tp)
    rng = np.random.default_rng(0)
    assert teng.compile_count == jeng.compile_count == 0
    for b, k in [(2, 3), (2, 3), (4, 3), (2, 2)]:
        bb = pipeline.bucket_batches(rng, data, n_rounds=b, k=k,
                                     clients_per_round=6, batch_size=8)
        etas = np.full(b, ETA, np.float32)
        jp, jf, jl, js = jeng.run_bucket(jp, bb.batches, bb.weights, etas,
                                         bb.active, js)
        tp, tf, tl, ts = teng.run_bucket(tp, bb.batches, bb.weights, etas,
                                         bb.active, ts)
        assert tuple(tf.shape) == (b, 6)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **KTOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **KTOL)
        assert_trees_close(tp, jp, **KTOL)
    assert teng.compile_count == jeng.compile_count == 3
    assert teng.dispatch_count == jeng.dispatch_count == 4
    assert teng.shared_count == jeng.shared_count == 0
    assert len(teng.registry) == len(jeng.registry) == 3
    # a private registry keeps the bare key: (codec signature, signature)
    assert all(len(key) == 3 for key in teng._executables)
    # on the CPU a program records no allocator peak
    assert all(executable_peak_bytes(e) == 0 == executable_peak_mb(e)
               for e in teng.registry.executables())


def _fed(**kw):
    return {**dict(total_clients=8, clients_per_round=4, rounds=8, k0=8,
                   eta0=ETA, batch_size=4, aggregator="kernel", seed=0),
            **kw}


@pytest.mark.parametrize("kw", [
    dict(k_schedule="rounds", k_quantize=True, bucket_rounds=4),
    dict(k_schedule="fixed", rounds=3, cohort_chunk=3, transport="int8",
         clients_per_round=5),
], ids=["k_quantize-bucket4", "chunked-int8"])
def test_trainer_counts_and_history_match_reference(kw):
    """A trainer run with quantized K in buckets of 4 (padded tails
    included), and a streamed one (slabs of 3 and a tail of 2: two "slab"
    keys and one "slabfin"), in both packages from the same params: the
    counts equal, the history's counters exact and its losses within the
    f32 tolerance."""
    task, params, data, jloss, tloss = femnist()
    f = _fed(**kw)
    jtr = JTrainer(jloss, jax.tree.map(jnp.asarray, params), data,
                   JFed(**f), JRuntime(task.model_size_mb, task.runtime,
                                       f["clients_per_round"]))
    tr = FedAvgTrainer(tloss, _torch(params), data, FedConfig(**f),
                       RuntimeModel(task.model_size_mb, task.runtime,
                                    f["clients_per_round"]), device="cpu")
    jh, h = jtr.run(f["rounds"]), tr.run(f["rounds"])
    assert (tr.compile_count, tr.shared_count, tr.dispatch_count) == \
        (jtr.compile_count, jtr.shared_count, jtr.dispatch_count)
    assert tr.dispatch_count < f["rounds"] or kw.get("cohort_chunk")
    for name in HISTORY_EXACT:
        assert getattr(h, name) == getattr(jh, name), name
    np.testing.assert_allclose(h.train_loss, jh.train_loss, **KTOL)
    assert_trees_close(tr.params, jtr.params, **KTOL)


def test_async_buffered_spec_counts_match_reference():
    """``examples/specs/async-buffered.json``, reduced: dispatch groups,
    folds and applies keyed as the reference's, so the counts and the event
    counters are equal."""
    ov = ["data.clients=8", "data.samples_per_client=8",
          "fed.clients_per_round=4", "fed.buffer_size=2", "fed.rounds=4",
          "fed.batch_size=4", "fed.max_staleness=4"]
    path = "examples/specs/async-buffered.json"
    jexp = jbuild(JSpec.load(path).with_overrides(*ov))
    texp = build(ExperimentSpec.load(path).with_overrides(*ov),
                 device="cpu")
    jh, h = jexp.run(), texp.run()
    jt, tt = jexp.trainer, texp.trainer
    assert (tt.compile_count, tt.shared_count, tt.dispatch_count) == \
        (jt.compile_count, jt.shared_count, jt.dispatch_count)
    assert tt.compile_count > 3          # dispatch groups of several sizes
    for name in ("rounds", "k", "sgd_steps", "wall_clock_s",
                 "applied_updates", "dropped_updates", "staleness"):
        assert getattr(h, name) == getattr(jh, name), name


# ---------------------------------------------------------------------------
# inside the port: bucket == rounds, padding transparent
# ---------------------------------------------------------------------------

def _engine(tloss, up, down, ref="f32"):
    return RoundEngine(tloss, aggregator="kernel", transport=up,
                       downlink=down, downlink_ref=ref, server="fedadam",
                       server_lr=0.05, device="cpu")


def _bucket(data, n, pad_to=None, seed=1):
    return pipeline.bucket_batches(np.random.default_rng(seed), data,
                                   n_rounds=n, k=2, clients_per_round=4,
                                   batch_size=4, pad_to=pad_to)


def _state(eng, params, server):
    return (params, server, eng.transport_state, eng.downlink_state)


@pytest.mark.parametrize("up,down", [("none", "none"), ("int8", "adaptive"),
                                     ("topk", "int8")])
def test_bucket_of_four_is_four_one_round_buckets_bitwise(up, down):
    _, params, data, _, tloss = femnist()
    bb = _bucket(data, 4)
    etas = np.asarray([0.3, 0.25, 0.2, 0.15], np.float32)
    outs = []
    for split in (False, True):
        eng = _engine(tloss, up, down)
        p = _torch(params)
        s = eng.init_server_state(p)
        firsts, levels = [], []
        spans = [(i, i + 1) for i in range(4)] if split else [(0, 4)]
        for lo, hi in spans:
            p, f, _, s = eng.run_bucket(
                p, {k: v[lo:hi] for k, v in bb.batches.items()},
                bb.weights[lo:hi], etas[lo:hi], bb.active[lo:hi], s)
            firsts.append(f)
            if eng.last_downlink_levels is not None:
                levels.append(eng.last_downlink_levels)
        assert eng.dispatch_count == len(spans)
        assert eng.compile_count == 1
        outs.append((_state(eng, p, s), torch.cat(firsts),
                     torch.cat(levels) if levels else None))
    (state4, f4, lv4), (state1, f1, lv1) = outs
    assert bitwise(state4, state1)
    assert torch.equal(f4, f1) and f4.shape == (4, 4)
    assert (lv4 is None and down == "none") or torch.equal(lv4, lv1)


@pytest.mark.parametrize("up,down,ref", [("int8", "adaptive", "f32"),
                                         ("int8", "int8", "q8")])
def test_padding_rounds_leave_every_state_bitwise(up, down, ref):
    """3 active rounds padded to 5: params, server, uplink and downlink
    state bitwise as after the 3 rounds alone; the padding rows' losses are
    NaN and their levels -1; the active rows equal."""
    _, params, data, _, tloss = femnist()
    etas = np.full(5, 0.3, np.float32)
    runs = {}
    for pad in (3, 5):
        bb = _bucket(data, 3, pad_to=pad)
        eng = _engine(tloss, up, down, ref)
        p = _torch(params)
        p, f, last, s = eng.run_bucket(p, bb.batches, bb.weights,
                                       etas[:pad], bb.active,
                                       eng.init_server_state(p))
        runs[pad] = (_state(eng, p, s), f, last, eng.last_downlink_levels)
    (s3, f3, l3, lv3), (s5, f5, l5, lv5) = runs[3], runs[5]
    assert bitwise(s3, s5)
    assert torch.equal(f5[:3], f3) and torch.equal(l5[:3], l3)
    assert bool(torch.isnan(f5[3:]).all()) and bool(torch.isnan(l5[3:])
                                                    .all())
    assert torch.equal(lv5[:3], lv3)
    assert lv5[3:].tolist() == [-1, -1]


# ---------------------------------------------------------------------------
# registry sharing (tests/test_fleet.py::TestRegistrySharing)
# ---------------------------------------------------------------------------

def _shared_pair(port: bool, **kw):
    make, spec, extra = ((build, port_spec, dict(device="cpu")) if port
                         else (jbuild, ref_spec, {}))
    reg = (ExecutableRegistry if port else JRegistry)()
    exps = [make(spec(**kw), registry=reg, **extra) for _ in range(2)]
    for e in exps:
        e.run()
    return reg, exps


def test_shared_hit_not_double_counted():
    counts = []
    for port in (False, True):
        reg, (a, b) = _shared_pair(port)
        counts.append((a.trainer.compile_count, a.trainer.shared_count,
                       b.trainer.compile_count, b.trainer.shared_count,
                       reg.compile_count, reg.hits, reg.misses))
    assert counts[1] == counts[0] == (1, 0, 0, 1, 1, 1, 1)


def test_shared_executable_is_same_object():
    _, (a, b) = _shared_pair(True)
    ex_a = list(a.trainer.engine._executables.values())
    ex_b = list(b.trainer.engine._executables.values())
    assert len(ex_a) == len(ex_b) == 1
    assert ex_a[0] is ex_b[0] and isinstance(ex_a[0], BucketProgram)
    # sharing changes no result: the two experiments train alike
    assert bitwise(a.params, b.params)


def test_same_k_bucket_different_k0_shares():
    got = []
    for port in (False, True):
        make, spec, extra = ((build, port_spec, dict(device="cpu")) if port
                             else (jbuild, ref_spec, {}))
        reg = (ExecutableRegistry if port else JRegistry)()
        exps = [make(spec(**{"fed.k0": k0, "fed.k_quantize": "true",
                             "fed.k_grid0": 16}), registry=reg, **extra)
                for k0 in (15, 16)]
        for e in exps:
            e.run()
        got.append([(e.trainer.compile_count, e.trainer.shared_count)
                    for e in exps])
        a, b = (list(e.trainer.engine._executables.values())[0]
                for e in exps)
        assert a is b
    assert got[1] == got[0] == [(1, 0), (0, 1)]


def test_transport_codecs_do_not_collide():
    counts = []
    for port in (False, True):
        make, spec, extra = ((build, port_spec, dict(device="cpu")) if port
                             else (jbuild, ref_spec, {}))
        reg = (ExecutableRegistry if port else JRegistry)()
        shared = []
        for name in ("none", "int8"):
            e = make(spec(**{"transport.name": name}), registry=reg, **extra)
            e.run()
            shared.append(e.trainer.shared_count)
        counts.append((shared, reg.compile_count))
    assert counts[1] == counts[0] == ([0, 0], 2)


@pytest.fixture
def world1(tmp_path):
    """A gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_transport_codecs_do_not_collide_mesh(world1):
    """The reference's mesh case, on a one-rank gloo group (the
    reference's own mesh runs fail under JAX 0.9, ROADMAP C6, so the port
    is held to the reference test's expected counts)."""
    reg = ExecutableRegistry()
    for name in ("none", "int8"):
        e = build(port_spec(**{"transport.name": name,
                               "backend.name": "mesh"}), registry=reg,
                  device="cpu")
        e.run()
        assert e.trainer.shared_count == 0
    assert reg.compile_count == 2


def test_registry_requires_program_key():
    for engine in (JEngine, lambda *a, **kw: RoundEngine(*a, device="cpu",
                                                         **kw)):
        reg = (JRegistry if engine is JEngine else ExecutableRegistry)()
        with pytest.raises(ValueError, match="program_key"):
            engine(lambda p, b: 0.0, registry=reg)


def test_private_registry_back_compat():
    e = build(port_spec(), device="cpu")
    e.run()
    je = jbuild(ref_spec())
    je.run()
    assert e.trainer.compile_count == je.trainer.compile_count == 1
    assert e.trainer.shared_count == je.trainer.shared_count == 0
    assert len(e.trainer.engine._executables) == 1


def test_program_key_distinguishes_codec_and_backend():
    kws = [{}, {"transport.name": "int8"}, {"backend.name": "mesh"},
           {"fed.k0": 2}]
    keys = [spec_program_key(port_spec(**kw)) for kw in kws]
    assert keys == [jspec_program_key(ref_spec(**kw)) for kw in kws]
    assert len(set(keys[:3])) == 3 and keys[3] == keys[0]


@pytest.mark.parametrize("registry", [JRegistry, ExecutableRegistry],
                         ids=["reference", "port"])
def test_single_flight_under_concurrency(registry):
    reg = registry()
    built = []
    gate = threading.Barrier(8)

    def build_fn():
        built.append(1)
        return object()

    results = []

    def lookup():
        gate.wait()
        results.append(reg.get_or_build(("k",), build_fn))

    threads = [threading.Thread(target=lookup) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(built) == 1
    assert len({id(r[0]) for r in results}) == 1
    assert sum(1 for r in results if r[1]) == 1
    assert (reg.compile_count, reg.hits, reg.misses) == (1, 7, 1)
