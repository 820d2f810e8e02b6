"""Streaming cohorts (``fed.cohort_chunk``) in the port, against the dense
round and against the reference (``tests/test_streaming.py``).

The contract: a round of U clients in slabs of C folds into f32 running
sums and stays the dense round: bitwise at C == U (params and codec state,
compared with ``torch.equal``), within 1e-6 at C < U without a codec, and
for a codec within one int8 quantisation step of each leaf's movement a
round, round by round from the dense run's state. The slab stream draws the
dense round's ids and samples draw for draw (and the reference's); the
engine refuses what slabs cannot honour; checkpoints are round-aligned; and
no tensor with a client axis longer than C reaches the slab core. Across
frameworks, ``examples/specs/population-chunked.json`` (rounds cut to 4)
continues from the reference's checkpoints with the counters exact."""
import jax
import numpy as np
import pytest
import torch

from repro.core.engine import sampling as jsampling
from repro.data import PopulationView as JPopulationView
from repro.data import pipeline as jpipeline
from repro_torch.api import ExperimentSpec, FederatedExperiment, build
from repro_torch.api.spec import SpecValidationError
from repro_torch.configs import get_paper_task
from repro_torch.core.engine import sampling
from repro_torch.core.engine.round import RoundEngine
from repro_torch.data import PopulationView, make_paper_task, pipeline
from repro_torch.models import small
from repro_torch.optim import tree_leaves, tree_map
from test_torch_parity_helpers import flat, lm_spec, record_ids
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

COHORT = 6
# tests/test_kernels.py's f32 tolerance, for losses across frameworks
KTOL = dict(rtol=2e-4, atol=2e-4)
# the codecs at C < U: |chunked - dense| <= ATOL + one int8 step (the
# leaf's movement in that round / 127), round by round from the dense
# state. Measured on the CPU: at worst 0.82 of that bound (int8 with a
# fixed cohort, C = 1), 0.63 (int8 uniform, C = 1), under 1e-4 of it at
# C = 3 and for top-k
ATOL = 1e-4
CONFIGS = [("none", "uniform", "mean"), ("none", "uniform", "kernel"),
           ("int8", "uniform", "mean"), ("int8", "fixed_cohort", "mean"),
           ("topk", "fixed_cohort", "mean")]
IDS = ["-".join(c) for c in CONFIGS]



def _spec(chunk=None, transport="none", sampler="uniform",
          aggregator="mean", *, rounds=4, bucket_rounds=2, prefetch=True):
    d = {
        "data": {"kind": "paper", "task": "femnist", "clients": 12,
                 "samples_per_client": 8, "seed": 0},
        "fed": {"clients_per_round": COHORT, "rounds": rounds, "k0": 2,
                "eta0": 0.3, "batch_size": 4, "eval_every": 0,
                "aggregator": aggregator, "bucket_rounds": bucket_rounds,
                "loss_window": 3, "seed": 0, "prefetch": prefetch},
        "transport": {"name": transport},
        "sampler": {"name": sampler},
    }
    if sampler == "fixed_cohort":
        d["sampler"]["cohort"] = list(range(COHORT))
    if chunk is not None:
        d["fed"]["cohort_chunk"] = chunk
    return ExperimentSpec.from_dict(d)


def _run(spec):
    exp = build(spec, device="cpu")
    exp.run()
    return exp


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


# ---------------------------------------------------------------------------
# the slab stream
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def femnist():
    return make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=12, samples_per_client=8)


@pytest.mark.parametrize("sampler", ["uniform", "population"])
@pytest.mark.parametrize("chunk", [1, 4, COHORT])
def test_round_slabs_draw_the_dense_round_and_the_reference(femnist, chunk,
                                                            sampler):
    """Concatenated, the slabs are the dense one-round build (batches and
    weights, slab weights the global ones sliced); slab by slab they are
    the reference's ``round_slabs``; all three leave one rng state."""
    data, jdata = femnist, femnist
    mk = {"uniform": (lambda: None, lambda: None),
          "population": (lambda: sampling.PopulationSampler(
              population=1000), lambda: jsampling.PopulationSampler(
              population=1000))}[sampler]
    if sampler == "population":
        data, jdata = PopulationView(femnist, 1000), JPopulationView(
            femnist, 1000)
    kw = dict(k=3, clients_per_round=COHORT, batch_size=4)
    rng, jrng, drng = (np.random.default_rng(5) for _ in range(3))
    slabs = list(pipeline.round_slabs(rng, data, chunk=chunk,
                                      sampler=mk[0](), round_id=2, **kw))
    jslabs = list(jpipeline.round_slabs(jrng, jdata, chunk=chunk,
                                        sampler=mk[1](), round_id=2, **kw))
    dense = pipeline.bucket_batches(drng, data, n_rounds=1, sampler=mk[0](),
                                    round_ids=[2], **kw)
    assert len(slabs) == len(jslabs) == -(-COHORT // chunk)
    for sb, jsb in zip(slabs, jslabs):
        assert (sb.start, sb.stop, sb.slab, sb.n_slabs) == (
            jsb.start, jsb.stop, jsb.slab, jsb.n_slabs)
        np.testing.assert_array_equal(sb.weights, jsb.weights)
        for key in jsb.batches:
            np.testing.assert_array_equal(sb.batches[key], jsb.batches[key])
            np.testing.assert_array_equal(
                sb.batches[key], dense.batches[key][0, sb.start:sb.stop])
    np.testing.assert_array_equal(
        np.concatenate([sb.weights for sb in slabs]), dense.weights[0])
    first, irng = mk[0](), np.random.default_rng(5)
    np.testing.assert_array_equal(
        np.concatenate([sb.ids for sb in slabs]),
        pipeline.sample_clients(irng, data, COHORT) if first is None
        else first.round(irng, data, COHORT, 2)[0])
    assert rng.bit_generator.state == jrng.bit_generator.state \
        == drng.bit_generator.state


@pytest.mark.parametrize("background", [False, True])
def test_builders_serve_a_round_as_its_slabs_in_order(femnist, background):
    """A bucket and a slab round submitted in turn come out in submission
    order off the one rng, through ``place_slab_fn``."""
    placed = []
    b = pipeline.make_builder(femnist, COHORT, 4, 3, background=background,
                              chunk=4, place_slab_fn=lambda sb: placed.append(
                                  sb.slab) or sb)
    b.submit_slabs(2, round_id=1)
    b.submit(1, 2, pad_to=1, rounds=[2])
    b.submit_slabs(2, round_id=3)
    try:
        got = [b.get() for _ in range(5)]
    finally:
        b.close()
    kinds = [type(x).__name__ for x in got]
    assert kinds == ["SlabBatch", "SlabBatch", "BucketBatch", "SlabBatch",
                     "SlabBatch"]
    assert placed == [0, 1, 0, 1]
    assert [x.stop - x.start for x in got if hasattr(x, "start")] == [4, 2,
                                                                      4, 2]


# ---------------------------------------------------------------------------
# C == U is the dense round; C < U within tolerance
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_runs():
    return {c: _run(_spec(None, *c)) for c in CONFIGS}


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_one_slab_of_the_whole_cohort_is_bitwise_dense(dense_runs, config):
    dense = dense_runs[config]
    full = _run(_spec(COHORT, *config))
    _equal(full.params, dense.params)
    if config[0] != "none":
        _equal(full.trainer.engine.transport_state,
               dense.trainer.engine.transport_state)
    assert full.history.train_loss == dense.history.train_loss
    # a streamed round is one dispatch; the dense run one a bucket of 2
    assert full.trainer.dispatch_count == 4
    assert dense.trainer.dispatch_count == 2


def test_cohort_chunk_none_leaves_the_dense_engine():
    """Without ``cohort_chunk`` (the spec's None) the engine has no slab
    cores and runs one ``run_bucket`` a bucket (rounds 5 and 6 are one
    bucket of 2)."""
    dense = _run(_spec(None))
    assert dense.spec.as_dict()["fed"]["cohort_chunk"] is None
    eng = dense.trainer.engine
    assert eng.cohort_chunk is None and not hasattr(eng, "slab_core")
    calls, run_bucket = [], eng.run_bucket
    eng.run_bucket = lambda *a: calls.append(1) or run_bucket(*a)
    dense.trainer.run(6, resume=True)
    assert len(calls) == 1 and eng.dispatch_count == 3


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_sub_cohort_slabs_hold_dense_round_by_round(config, chunk):
    """Each round runs dense and chunked from the dense run's state (both
    trainers draw the same stream): the plain path within 1e-6, a codec
    within ATOL + one int8 step of each leaf's movement that round."""
    dense = build(_spec(None, *config), device="cpu")
    chunked = build(_spec(chunk, *config), device="cpu")
    worst = 0.0
    for r in range(1, 5):
        before = _clone(dense.params)
        dense.trainer.run(r, resume=True)
        chunked.trainer.run(r, resume=True)
        fd, fc, fb = flat(dense.params), flat(chunked.params), flat(before)
        for k in fd:
            diff = float(np.max(np.abs(fc[k] - fd[k])))
            if config[0] == "none":
                assert diff <= 1e-6, (r, k, diff)
                continue
            step = float(np.max(np.abs(fd[k] - fb[k]))) / 127.0
            assert diff <= ATOL + step, (r, k, diff, step)
            worst = max(worst, diff / (ATOL + step))
        np.testing.assert_allclose(chunked.history.train_loss,
                                   dense.history.train_loss, rtol=1e-5,
                                   atol=1e-5)
        chunked.trainer.params = _clone(dense.params)
        if config[0] != "none":
            chunked.trainer.engine.transport_state = _clone(
                dense.trainer.engine.transport_state)
    assert worst <= 1.0


def test_chunked_matches_dense_across_bucket_rounds():
    """Chunking makes every bucket one round; the dense run with 4-round
    buckets is the same training."""
    dense = _run(_spec(None, bucket_rounds=4))
    _equal(_run(_spec(COHORT, bucket_rounds=4)).params, dense.params)


def test_chunked_prefetch_on_and_off_are_bitwise():
    pre = _run(_spec(3, "int8"))
    sync = _run(_spec(3, "int8", prefetch=False))
    _equal(pre.params, sync.params)
    _equal(pre.trainer.engine.transport_state,
           sync.trainer.engine.transport_state)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_engine_and_spec_refuse_what_slabs_cannot_honour():
    task = get_paper_task("femnist")
    loss_fn = lambda p, b: small.task_loss(p, task, b)
    for agg in ("median", "trimmed_mean"):
        with pytest.raises(ValueError, match="running weighted sum"):
            RoundEngine(loss_fn, aggregator=agg, cohort_chunk=2,
                        device="cpu")
        with pytest.raises(SpecValidationError,
                           match="running weighted sum"):
            _spec(3, aggregator=agg).validate()
    with pytest.raises(ValueError, match="downlink"):
        RoundEngine(loss_fn, transport="int8", downlink="int8",
                    cohort_chunk=2, device="cpu")
    with pytest.raises(SpecValidationError, match="downlink"):
        _spec(3, "int8").with_overrides("transport.downlink=int8").validate()
    eng = RoundEngine(loss_fn, device="cpu")
    with pytest.raises(ValueError, match="without cohort_chunk"):
        eng.run_round_chunked({}, [], 0.1, ())


# ---------------------------------------------------------------------------
# checkpoints: round-aligned, never mid-round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport,sampler", [("none", "uniform"),
                                               ("int8", "uniform"),
                                               ("int8", "fixed_cohort")])
def test_dense_checkpoint_resumes_bitwise_into_chunked(tmp_path, transport,
                                                       sampler):
    straight = _run(_spec(None, transport, sampler))
    half = build(_spec(None, transport, sampler), device="cpu")
    half.run(rounds=2)
    path = str(tmp_path / "dense2")
    half.trainer.save_state(path)
    cont = build(_spec(COHORT, transport, sampler), device="cpu")
    cont.trainer.restore_state(path)
    cont.trainer.run(4, resume=True)
    _equal(cont.params, straight.params)
    if transport != "none":
        _equal(cont.trainer.engine.transport_state,
               straight.trainer.engine.transport_state)
    assert straight.history.as_dict() == cont.history.as_dict()


def test_chunked_checkpoint_is_round_aligned(tmp_path):
    """The per-client residual keeps its (U, ...) leading axis, never a
    slab's, and a chunked checkpoint resumes bitwise."""
    spec = _spec(2, "int8", "fixed_cohort")
    straight = _run(spec)
    half = build(spec, device="cpu")
    half.run(rounds=2)
    state = half.trainer.engine.transport_state
    assert {t.shape[0] for t in tree_leaves(state)} == {COHORT}
    path = str(tmp_path / "chunk2")
    half.save(path)
    cont = FederatedExperiment.restore(path, device="cpu")
    cont.trainer.run(4, resume=True)
    _equal(cont.params, straight.params)
    _equal(cont.trainer.engine.transport_state,
           straight.trainer.engine.transport_state)
    assert straight.history.as_dict() == cont.history.as_dict()


# ---------------------------------------------------------------------------
# O(C) by shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport,sampler", [("none", "uniform"),
                                               ("int8", "uniform"),
                                               ("int8", "fixed_cohort")])
def test_no_client_axis_longer_than_c_reaches_the_slab_core(transport,
                                                            sampler):
    """Every tensor the slab core receives with a client axis (batches,
    weights, residual slices) and every client-stacked tensor it makes
    has at most C rows; the codec's reduce sees C rows too."""
    from repro_torch.kernels import ops
    chunk = 4
    exp = build(_spec(chunk, transport, sampler), device="cpu")
    eng = exp.trainer.engine
    rows, core = [], eng.slab_core

    def recorded(params, batches, weights, eta, acc, ef):
        rows.append(int(weights.shape[0]))
        rows.extend(int(v.shape[0]) for v in batches.values())
        if sampler == "fixed_cohort":
            rows.extend(int(t.shape[0]) for t in tree_leaves(ef))
        return core(params, batches, weights, eta, acc, ef)

    eng.slab_core = recorded
    reduce_rows, reduce = [], ops.int8_delta_reduce

    def counted(q, *a):
        reduce_rows.append(int(q.shape[0]))
        return reduce(q, *a)

    ops.int8_delta_reduce = counted
    try:
        exp.run(2)
    finally:
        ops.int8_delta_reduce = reduce
    assert max(rows) == chunk and sorted(set(rows)) == [2, 4]
    if transport == "int8":
        assert max(reduce_rows) == chunk
        assert len(reduce_rows) == 2 * 2 * len(tree_leaves(exp.params))


def test_peak_mb_reads_nothing_on_the_cpu():
    """``core.mem`` reads the CUDA allocator's peak; a CPU engine has no
    allocator statistics and reads 0.0, as the reference reads 0 where
    the runtime gives none."""
    from repro_torch.core import engine_peak_mb, trainer_peak_mb
    exp = build(_spec(3), device="cpu")
    assert trainer_peak_mb(exp.trainer) == 0.0
    assert engine_peak_mb(exp.trainer.engine) == 0.0
    aexp = build(_spec().with_overrides("fed.aggregation=async"),
                 device="cpu")
    assert trainer_peak_mb(aexp.trainer) == 0.0


# ---------------------------------------------------------------------------
# across frameworks: population-chunked.json from the reference's state
# ---------------------------------------------------------------------------

CHUNK_ROUNDS = 4
COUNTERS = ("rounds", "k", "eta", "sgd_steps", "wall_clock_s",
            "uplink_mbit", "downlink_mbit")


def test_population_chunked_continues_from_reference_checkpoints(tmp_path):
    """The reference builds ``population-chunked.json`` (64 FEMNIST
    clients, a 10^6-id population, 32 a round in 8 slabs of 4, int8) with
    rounds cut to 4 and saves before each round. The port restores each
    checkpoint and runs the next round: ids, K_r, ``sgd_steps``,
    ``wall_clock_s`` and the wire Mbit exact, losses at the f32 kernel
    tolerance, params within one int8 step of each leaf's movement that
    round (whole int8 runs drift apart, ROADMAP C5)."""
    from repro.api.experiment import build as jbuild
    spec = lm_spec("population-chunked", f"fed.rounds={CHUNK_ROUNDS}")
    jexp = jbuild(spec)
    jids = record_ids(jexp.trainer)
    paths, states = [], []
    for r in range(CHUNK_ROUNDS):
        paths.append(str(tmp_path / f"r{r}"))
        jexp.save(paths[-1])
        states.append(jax.tree.map(np.asarray, jexp.params))
        jexp.trainer.run(r + 1, resume=True)
    states.append(jax.tree.map(np.asarray, jexp.params))
    jh = jexp.history
    assert jexp.trainer.dispatch_count == CHUNK_ROUNDS
    for r, path in enumerate(paths):
        exp = FederatedExperiment.restore(path, device="cpu")
        assert exp.trainer.fed.cohort_chunk == 4
        ids = record_ids(exp.trainer)
        h = exp.trainer.run(r + 1, resume=True)
        assert ids == jids[r:r + 1]
        for key in COUNTERS:
            assert getattr(h, key) == getattr(jh, key)[:r + 1], key
        np.testing.assert_allclose(h.train_loss, jh.train_loss[:r + 1],
                                   **KTOL)
        fg, fw, f0 = flat(exp.params), flat(states[r + 1]), flat(states[r])
        assert sorted(fg) == sorted(fw)
        for k in fw:
            step = float(np.max(np.abs(fw[k] - f0[k]))) / 127.0
            assert float(np.max(np.abs(fg[k] - fw[k]))) <= ATOL + step, \
                (r, k)
