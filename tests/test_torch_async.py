"""Async buffered aggregation (``fed.aggregation="async"``,
``AsyncBufferedEngine``) in the port, against the synchronous trainer and
against the reference (``tests/test_async.py``).

The sync-parity oracle (heterogeneity 0, a buffer of the whole cohort,
``constant`` weight) follows ``FedAvgTrainer``; the event trace (which
slots fold, their clients and start versions, the staleness list, applied
and dropped counts, the event clock, steps and wire) is the reference's
exactly on the same spec, from the reference's own checkpoints; a
mid-buffer checkpoint resumes bitwise; and the engine refuses what the
spec refuses."""
import contextlib
import io
import os

import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JSpec
from repro.api import registries as jreg
from repro.api.experiment import build as jbuild
from repro_torch.api import ExperimentSpec, FederatedExperiment, build
from repro_torch.api.registries import (STALENESS_WEIGHT_REGISTRY,
                                        UnknownNameError)
from repro_torch.configs import get_paper_task
from repro_torch.configs.base import FedConfig
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.core.engine import (STALENESS_WEIGHTS, AsyncBufferedEngine,
                                     get_staleness_weight)
from repro_torch.data import make_paper_task
from repro_torch.models import small
from repro_torch.optim import tree_leaves
from test_torch_parity_helpers import flat
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

BASE = ("data.kind=paper", "data.task=femnist", "data.clients=16",
        "fed.clients_per_round=8", "fed.rounds=6", "fed.k0=4",
        "fed.batch_size=8", "fed.eval_every=0")
ASYNC_HET = ("fed.rounds=8", "fed.aggregation=async", "fed.buffer_size=3",
             "fed.staleness_weight=inv", "fed.k_schedule=rounds",
             "runtime.heterogeneity=0.7", "fed.max_staleness=4")
# tests/test_kernels.py's f32 tolerance, for losses across frameworks
KTOL = dict(rtol=2e-4, atol=2e-4)
ATOL = 1e-4
HISTORY = ("rounds", "k", "eta", "wall_clock_s", "sgd_steps", "uplink_mbit",
           "downlink_mbit", "staleness", "applied_updates",
           "dropped_updates")



def spec_with(*overrides):
    return ExperimentSpec().with_overrides(*BASE, *overrides)


def _equal(a, b):
    """Bitwise by ``torch.equal``; ``()`` (no codec state) on both sides
    passes."""
    if a == () or b == ():
        assert a == b == ()
        return
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def record_trace(engine):
    """Every arrival the engine pops, as (slot, client, start version,
    version at arrival): the engines of both packages keep these names."""
    trace, fold = [], engine._fold_arrival

    def fold_(slot):
        trace.append((int(slot), int(engine._slot_client[slot]),
                      int(engine._slot_version[slot]),
                      int(engine._version)))
        return fold(slot)

    engine._fold_arrival = fold_
    return trace


# ---------------------------------------------------------------------------
# the sync-parity oracle
# ---------------------------------------------------------------------------

def test_async_sync_parity_oracle():
    """Zero jitter and a buffer of the whole cohort reproduce the
    synchronous trainer under K_r-rounds: rounds, K and eta equal, losses
    within 5e-6, wall clock, steps and downlink exact, uplink within rtol
    1e-12, nobody stale."""
    hs = build(spec_with("fed.k_schedule=rounds"), device="cpu").run()
    exp = build(spec_with("fed.k_schedule=rounds", "fed.aggregation=async"),
                device="cpu")
    assert isinstance(exp.trainer, AsyncBufferedEngine)
    ha = exp.run()
    assert ha.rounds == hs.rounds and ha.k == hs.k and ha.eta == hs.eta
    np.testing.assert_allclose(ha.train_loss, hs.train_loss, rtol=0,
                               atol=5e-6)
    assert ha.wall_clock_s == hs.wall_clock_s
    assert ha.sgd_steps == hs.sgd_steps
    assert ha.downlink_mbit == hs.downlink_mbit
    np.testing.assert_allclose(ha.uplink_mbit, hs.uplink_mbit, rtol=1e-12)
    assert all(s == 0.0 for s in ha.staleness)


# ---------------------------------------------------------------------------
# the event trace against the reference, from its checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["none", "int8"])
def reference_run(request, tmp_path_factory):
    """The reference's run of the ASYNC_HET spec with ``transport``:
    checkpoints before the first dispatch and after 4 applications, the
    params after 4 and 5, its history and its trace."""
    tmp = tmp_path_factory.mktemp(f"async-{request.param}")
    spec = JSpec().with_overrides(*BASE, *ASYNC_HET,
                                  f"transport.name={request.param}")
    jexp = jbuild(spec)
    trace = record_trace(jexp.trainer)
    r0, r4 = str(tmp / "r0"), str(tmp / "r4")
    jexp.save(r0)
    jexp.trainer.run(4)
    jexp.save(r4)
    n4 = len(trace)
    p4 = jax.tree.map(np.asarray, jexp.params)
    jexp.trainer.run(5)
    p5 = jax.tree.map(np.asarray, jexp.params)
    jexp.trainer.run(8)
    return {"transport": request.param, "r0": r0, "r4": r4, "p4": p4,
            "p5": p5, "trace": trace, "n4": n4,
            "history": jexp.history.as_dict(),
            "hist": dict(jexp.trainer.staleness_hist)}


def _holds_trace(exp, ref):
    h = exp.history.as_dict()
    for key in HISTORY:
        assert h[key] == ref["history"][key], key
    assert exp.trainer.staleness_hist == ref["hist"]
    assert exp.trainer.store.version == 8


def test_event_trace_equals_the_reference_from_its_start(reference_run):
    """From the reference's round-0 checkpoint (its params): the same
    arrivals, clients, start versions, staleness, drops, clock, steps and
    wire; losses allclose without a codec."""
    ref = reference_run
    exp = FederatedExperiment.restore(ref["r0"], device="cpu")
    assert isinstance(exp.trainer, AsyncBufferedEngine)
    trace = record_trace(exp.trainer)
    exp.trainer.run(8, resume=True)
    assert trace == ref["trace"]
    _holds_trace(exp, ref)
    if ref["transport"] == "none":
        np.testing.assert_allclose(exp.history.train_loss,
                                   ref["history"]["train_loss"], **KTOL)


def test_reference_checkpoint_continues_in_the_port(reference_run):
    """A mid-buffer reference checkpoint (after 4 applications: heap,
    version vector, buffer, in-flight deltas, residual slots, both rng
    states) restores bit for bit and continues with the trace exact; the
    next application's params lie within one int8 step of each leaf's
    movement (ATOL alone without a codec)."""
    ref = reference_run
    exp = FederatedExperiment.restore(ref["r4"], device="cpu")
    tr = exp.trainer
    with np.load(os.path.join(ref["r4"], "arrays.npz")) as data:
        held = {k.rstrip("/"): v for k, v in flat(
            {**tr.store.checkpoint_tree(), "buffer": tr._buffer,
             "inflight": tr._inflight}).items()
            if v.size or k.rstrip("/") in data}
        assert sorted(held) == sorted(data)
        for k in data:
            np.testing.assert_array_equal(held[k], data[k], err_msg=k)
    trace = record_trace(tr)
    tr.run(5, resume=True)
    fg, fw, f0 = flat(exp.params), flat(ref["p5"]), flat(ref["p4"])
    for k in fw:
        step = (float(np.max(np.abs(fw[k] - f0[k]))) / 127.0
                if ref["transport"] == "int8" else 0.0)
        assert float(np.max(np.abs(fg[k] - fw[k]))) <= ATOL + step, k
    tr.run(8, resume=True)
    assert trace == ref["trace"][ref["n4"]:]
    _holds_trace(exp, ref)


# ---------------------------------------------------------------------------
# checkpoints in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", ["none", "int8"])
def test_mid_buffer_checkpoint_resumes_bitwise(tmp_path, transport):
    """Saved with a part-filled buffer, in-flight deltas and a non-empty
    heap, restored through ``FederatedExperiment.restore``: history,
    params, residual slots and the staleness histogram bitwise the
    uninterrupted run's; the heap, version vector, buffer, in-flight
    deltas and rng states restored exactly."""
    spec = spec_with(*ASYNC_HET, f"transport.name={transport}")
    ref = build(spec, device="cpu")
    href = ref.run()
    a = build(spec, device="cpu")
    a.trainer.run(4)
    assert a.trainer._buf_count != 0 or a.trainer._heap
    ck = os.path.join(tmp_path, "ck")
    a.save(ck)
    b = FederatedExperiment.restore(ck, device="cpu")
    tb, ta = b.trainer, a.trainer
    assert type(tb) is AsyncBufferedEngine
    assert tb._heap == ta._heap and tb._sim_time == ta._sim_time
    assert (tb._slot_version == ta._slot_version).all()
    assert (tb._slot_client == ta._slot_client).all()
    assert tb._buf_weight == ta._buf_weight
    assert tb._np_rng.bit_generator.state == ta._np_rng.bit_generator.state
    assert tb.runtime._rng.bit_generator.state == \
        ta.runtime._rng.bit_generator.state
    _equal(tb._inflight, ta._inflight)
    _equal(tb._buffer, ta._buffer)
    hb = tb.run(8, resume=True)
    assert hb.as_dict() == href.as_dict()
    assert tb.staleness_hist == ref.trainer.staleness_hist
    _equal(tb.params, ref.trainer.params)
    _equal(tb.transport_state, ref.trainer.transport_state)
    if transport == "int8":
        assert tree_leaves(tb.transport_state)[0].shape[0] == 8


# ---------------------------------------------------------------------------
# staleness semantics
# ---------------------------------------------------------------------------

def test_staleness_weight_builtins_match_the_reference():
    from repro.core.engine import async_buffer as jasync
    assert STALENESS_WEIGHTS == jasync.STALENESS_WEIGHTS
    assert get_staleness_weight("constant")(3) == 1.0
    assert get_staleness_weight("inv")(3) == pytest.approx(0.25)
    assert get_staleness_weight("poly")(3) == pytest.approx(0.5)
    for name in STALENESS_WEIGHTS:
        assert [get_staleness_weight(name)(s) for s in range(8)] == \
            [jasync.get_staleness_weight(name)(s) for s in range(8)]
    fn = lambda s: 2.0
    assert get_staleness_weight(fn) is fn
    with pytest.raises(UnknownNameError, match="Did you mean 'inv'"):
        STALENESS_WEIGHT_REGISTRY.get("inf")
    assert jreg.STALENESS_WEIGHT_REGISTRY.available() == \
        STALENESS_WEIGHT_REGISTRY.available()


def test_max_staleness_drops_are_counted_and_charged():
    spec = spec_with("fed.aggregation=async", "fed.buffer_size=2",
                     "fed.max_staleness=0", "runtime.heterogeneity=1.0",
                     "fed.rounds=4")
    exp = build(spec, device="cpu")
    h = exp.run()
    tr = exp.trainer
    assert tr.dropped_updates > 0
    assert h.dropped_updates[-1] == tr.dropped_updates
    assert sum(tr.staleness_hist.values()) == \
        tr.applied_updates + tr.dropped_updates
    arrivals = tr.applied_updates + tr.dropped_updates + tr._buf_count
    assert h.uplink_mbit[-1] == pytest.approx(
        arrivals * tr.runtime.uplink_mbit_per_client)


def test_async_history_gains_staleness_columns_and_the_launcher_reports():
    from repro_torch.launch import train
    h = build(spec_with("fed.aggregation=async",
                        "runtime.heterogeneity=0.5"), device="cpu").run()
    assert len(h.staleness) == len(h.applied_updates) == len(h.rounds)
    assert len(h.dropped_updates) == len(h.rounds)
    assert h.applied_updates == sorted(h.applied_updates)
    assert np.isfinite(h.train_loss).all()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exp = train.main(["--spec", "examples/specs/async-buffered.json",
                          "--set", "fed.rounds=2", "--device", "cpu"])
    text = out.getvalue()
    assert ("[train] aggregation=async: buffer_size=8, "
            "staleness_weight=inv, max_staleness=16") in text
    assert "per-client EF x16" in text
    assert (f"[train] async: {exp.trainer.applied_updates} updates applied, "
            f"{exp.trainer.dropped_updates} dropped") in text


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

class _Sequential:
    name, strategy, device = "mesh", "sequential", torch.device("cpu")


def test_engine_refusals_mirror_the_spec():
    """A FedConfig built by hand, past the spec's validation, still meets
    the engine's refusals; ``FedAvgTrainer`` refuses async by name."""
    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=8, samples_per_client=20)
    loss_fn = lambda p, b: small.task_loss(p, task, b)
    params = small.init_task_model(0, task, device="cpu")
    rt = RuntimeModel(task.model_size_mb, task.runtime, 4)

    def fed(**kw):
        return FedConfig(total_clients=8, clients_per_round=4, rounds=2,
                         k0=2, batch_size=4, aggregation="async", **kw)

    def engine(backend=None, **kw):
        return AsyncBufferedEngine(loss_fn, params, data, fed(**kw), rt,
                                   backend=backend, device="cpu")

    for kw, msg in [(dict(aggregator="median"), "linear"),
                    (dict(cohort_chunk=2), "cohort_chunk"),
                    (dict(downlink="int8"), "downlink"),
                    (dict(buffer_size=64), "buffer_size"),
                    (dict(buffer_size=0), "buffer_size"),
                    (dict(sampler="fixed_cohort", cohort=(0, 1, 2, 3)),
                     "ragged")]:
        with pytest.raises(ValueError, match=msg):
            engine(**kw)
    with pytest.raises(ValueError, match="sequential"):
        engine(backend=_Sequential())
    with pytest.raises(ValueError, match=r"FedAvgTrainer.*build.*"
                       r"AsyncBufferedEngine"):
        FedAvgTrainer(loss_fn, params, data, fed(), rt, device="cpu")
    assert engine().buffer_size == 4


@pytest.mark.parametrize("overrides, msg", [
    (("fed.aggregation=async", "fed.aggregator=median"), "robust"),
    (("fed.aggregation=async", "fed.cohort_chunk=4"), "cohort_chunk"),
    (("fed.aggregation=async", "fed.buffer_size=9"), "buffer_size"),
    (("fed.aggregation=async", "transport.downlink=int8"), "downlink"),
    (("fed.aggregation=async", "sampler.name=fixed_cohort"), "sampler"),
    (("fed.aggregation=async", "backend.name=mesh",
      "backend.strategy=sequential"), "sequential"),
])
def test_spec_refusals_match_the_reference(overrides, msg):
    with pytest.raises(ValueError, match=msg) as got:
        spec_with(*overrides).validate()
    with pytest.raises(ValueError) as want:
        JSpec().with_overrides(*BASE, *overrides).validate()
    assert [m.replace("repro_torch.", "repro.") for m in got.value.errors] \
        == want.value.errors
