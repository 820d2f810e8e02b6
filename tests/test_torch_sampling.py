"""The port's samplers, ``PopulationView`` and per-client error feedback
against the reference on the CPU: every sampler draw for draw on the same
seed (ids, weights and the rng state after), the sparse availability round
and the population sampler over a 10^6-client ``PopulationView``, the
slotted residual of ``Transport.with_ef_slots``, the trainer's switch to it
under a fixed cohort, and ``fixed-cohort-topk`` (reduced qwen1.5-0.5b,
cohort [0, 3, 5, 9], top-k 0.25) as a whole run and round by round from
the reference's state, residual slot by slot."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import sampling as jsampling
from repro.core.engine import transport as jtransport
from repro.data import PopulationView as JPopulationView
from repro.data import pipeline as jpipeline
from repro_torch.configs import FedConfig, get_arch, get_paper_task
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.core.engine import sampling
from repro_torch.core.engine import transport
from repro_torch.core.engine.backends import MeshBackend
from repro_torch.core.engine.round import RoundEngine
from repro_torch.data import PopulationView, make_paper_task, pipeline
from repro_torch.data.synthetic import FederatedData
from repro_torch.models import registry, small
from test_torch_parity_helpers import (TOL, _np, _torch,
                                       assert_counters_equal, flat, lm_spec,
                                       lm_trainers, to_port_state)
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def data():
    """14 clients of uneven sizes (two without data), so the weighted draw
    and the shortfall weights show."""
    rng = np.random.default_rng(0)
    sizes = [40, 3, 17, 0, 25, 8, 60, 11, 0, 5, 30, 14, 9, 21]
    cy = [rng.integers(0, 5, size=n) for n in sizes]
    cx = [rng.normal(size=(n, 3)).astype(np.float32) for n in sizes]
    return FederatedData(cx, cy, cx[0], cy[0], 5)


def _draws(sampler, data, n, rounds, seed=7):
    rng = np.random.default_rng(seed)
    out = [sampler.round(rng, data, n, round_idx=r + 1)
           for r in range(rounds)]
    return out, rng.bit_generator.state


def _assert_same_draws(port, ref, data, n, rounds=30, seed=7):
    got, state = _draws(port, data, n, rounds, seed)
    want, jstate = _draws(ref, data, n, rounds, seed)
    for (ids, w), (jids, jw) in zip(got, want):
        np.testing.assert_array_equal(ids, jids)
        assert w.dtype == jw.dtype == np.float32
        np.testing.assert_array_equal(w, jw)
    assert state == jstate
    return got


SAMPLERS = [
    ("uniform", {}, 5),
    ("weighted", {}, 5),
    ("fixed_cohort", {"cohort": (3, 1, 8, 12)}, 4),
    ("availability", {"prob": 0.25}, 6),            # shortfalls occur
    ("availability", {"prob": 1e-12}, 5),           # all-offline re-draw
    ("availability", {"prob": 0.8}, 5),
    ("population", {"population": 0, "peak": 0.9, "base": 0.05,
                    "day_rounds": 24}, 6),
]


@pytest.mark.parametrize("name,kw,n", SAMPLERS,
                         ids=[f"{s}-{'-'.join(map(str, kw.values()))}"
                              for s, kw, _ in SAMPLERS])
def test_sampler_draws_the_reference_ids_and_weights(data, name, kw, n):
    cls = {"uniform": "UniformSampler", "weighted": "WeightedSampler",
           "fixed_cohort": "FixedCohortSampler",
           "availability": "AvailabilitySampler",
           "population": "PopulationSampler"}[name]
    port, ref = getattr(sampling, cls)(**kw), getattr(jsampling, cls)(**kw)
    assert port.name == ref.name == name
    assert port.stateful_cohort == ref.stateful_cohort
    assert port.needs_weighted_aggregation == ref.needs_weighted_aggregation
    got = _assert_same_draws(port, ref, data, n)
    if name == "availability" and kw["prob"] == 0.25:
        assert any((w == 0).any() for _, w in got)   # the shortfall path ran


@pytest.fixture(scope="module")
def views(data):
    return (PopulationView(data, 1_000_000),
            JPopulationView(data, 1_000_000))


@pytest.mark.parametrize("prob", [0.5, 1e-7])
def test_sparse_availability_round_matches_reference(views, prob):
    """Above ``DENSE_MAX`` the O(cohort) rejection draw, and at a
    pathological prob its shortfall: offline ids padded at weight 0."""
    view, jview = views
    assert view.num_clients > sampling.AvailabilitySampler.DENSE_MAX
    s, js = (sampling.AvailabilitySampler(prob),
             jsampling.AvailabilitySampler(prob))
    for seed in range(5):
        got, state = _draws(s, view, 32, 10, seed)
        want, jstate = _draws(js, jview, 32, 10, seed)
        for (ids, w), (jids, jw) in zip(got, want):
            assert ids.shape == (32,) and len(set(ids.tolist())) == 32
            np.testing.assert_array_equal(ids, jids)
            np.testing.assert_array_equal(w, jw)
        assert state == jstate


@pytest.mark.parametrize("kw", [
    dict(peak=0.9, base=0.05, day_rounds=24),
    dict(peak=0.5, base=1e-4, day_rounds=5),        # shortfall padding
])
def test_population_sampler_over_a_population_view(views, kw):
    """``population`` over a 10^6-client ``PopulationView``: ids, weights,
    the per-id availability curve and the hashes, round by round."""
    view, jview = views
    s = sampling.PopulationSampler(population=1_000_000, **kw)
    js = jsampling.PopulationSampler(population=1_000_000, **kw)
    for seed in range(3):
        got, state = _draws(s, view, 32, 30, seed)
        want, jstate = _draws(js, jview, 32, 30, seed)
        for (ids, w), (jids, jw) in zip(got, want):
            np.testing.assert_array_equal(ids, jids)
            np.testing.assert_array_equal(w, jw)
        assert state == jstate
    ids = np.arange(0, 1_000_000, 9973)
    np.testing.assert_array_equal(sampling.splitmix64(ids),
                                  jsampling.splitmix64(ids))
    np.testing.assert_array_equal(sampling._hash_unit(ids),
                                  jsampling._hash_unit(ids))
    for r in (1, 7, 13, 24):
        np.testing.assert_array_equal(s.availability(ids, r),
                                      js.availability(ids, r))


@pytest.mark.parametrize("N,k,exclude", [
    (1_000_000, 20, [5, 17, 999_999]),
    (10, 6, [0, 2, 4]),                     # tiny N: the exact set diff
])
def test_draw_distinct_and_stable_unique_match_reference(N, k, exclude):
    ex = np.asarray(exclude, np.int64)
    got = sampling._draw_distinct(np.random.default_rng(1), N, k, ex)
    want = jsampling._draw_distinct(np.random.default_rng(1), N, k, ex)
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got, ex).any() and len(set(got.tolist())) == k
    a = np.array([5, 3, 5, 9, 3, 1])
    np.testing.assert_array_equal(sampling._stable_unique(a),
                                  jsampling._stable_unique(a))


def test_population_view_matches_reference(data, views):
    view, jview = views
    assert view.num_clients == jview.num_clients == 1_000_000
    assert len(view.client_y) == len(jview.client_y)
    for i in (0, 13, 14, 999_999, -1):
        np.testing.assert_array_equal(view.client_x[i], jview.client_x[i])
        np.testing.assert_array_equal(view.client_y[i], jview.client_y[i])
    with pytest.raises(IndexError):
        view.client_y[1_000_000]
    with pytest.raises(NotImplementedError):
        view.weights
    assert view.num_classes == data.num_classes and view.base is data
    assert repr(view) == repr(jview)
    with pytest.raises(ValueError, match="population"):
        PopulationView(data, 0)


def test_bucket_batches_through_a_sampler_match_reference(views):
    """The pipeline forwards absolute round ids to the sampler: a bucket
    of population rounds is the reference's, batch for batch."""
    view, jview = views
    kw = dict(n_rounds=3, k=2, clients_per_round=6, batch_size=4,
              round_ids=[4, 5, 6])
    got = pipeline.bucket_batches(
        np.random.default_rng(2), view,
        sampler=sampling.PopulationSampler(population=1_000_000), **kw)
    want = jpipeline.bucket_batches(
        np.random.default_rng(2), jview,
        sampler=jsampling.PopulationSampler(population=1_000_000), **kw)
    for key in want.batches:
        np.testing.assert_array_equal(got.batches[key], want.batches[key])
    np.testing.assert_array_equal(got.weights, want.weights)


@pytest.mark.parametrize("name", list(jsampling.SAMPLERS))
def test_make_sampler_reads_the_fed_config_as_the_reference(name):
    from repro.configs.base import FedConfig as JFed
    kw = dict(sampler=name, cohort=(2, 0, 1), availability=0.6,
              population=5000, day_rounds=12, base_availability=0.02)
    got, want = (sampling.make_sampler(FedConfig(**kw)),
                 jsampling.make_sampler(JFed(**kw)))
    assert type(got).__name__ == type(want).__name__
    assert {k: v for k, v in vars(got).items()} == \
        {k: v for k, v in vars(want).items()}
    assert sampling.SAMPLERS == jsampling.SAMPLERS
    assert sampling.get_sampler(got) is got
    with pytest.raises(ValueError, match="unknown sampler"):
        sampling.get_sampler("round_robin")


# ---------------------------------------------------------------------------
# per-client error feedback
# ---------------------------------------------------------------------------

def test_ef_slots_state_shape_and_signature():
    t = transport.Int8Transport(levels=1, error_feedback=True)
    t4 = t.with_ef_slots(4)
    params = {"w": torch.zeros((5, 3))}
    assert t.ef_slots is None and t4.ef_slots == 4
    assert t.init_state(params)["w"].shape == (5, 3)
    assert t4.init_state(params)["w"].shape == (4, 5, 3)
    assert t.signature() != t4.signature()
    j4 = jtransport.Int8Transport(levels=1, error_feedback=True) \
        .with_ef_slots(4)
    assert t4.signature() == j4.signature()
    assert transport.TopKTransport(0.25).with_ef_slots(3).signature() == \
        jtransport.TopKTransport(0.25).with_ef_slots(3).signature()
    t2 = transport.Int8Transport(levels=2, error_feedback=False)
    assert t2.with_ef_slots(4) is t2              # no feedback, no slots


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_slotted_aggregate_matches_reference(codec):
    """``aggregate`` with one residual slot a client, three calls in a row
    from the same inputs: the aggregate and every slot's residual."""
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(size=(40, 7)).astype(np.float32),
              "b": rng.normal(size=(8,)).astype(np.float32)}
    w = np.array([0.5, 0.3, 0.2], np.float32)
    mk = lambda mod: (mod.Int8Transport(levels=1, error_feedback=True)
                      if codec == "int8" else mod.TopKTransport(0.3))
    t, jt = mk(transport).with_ef_slots(3), mk(jtransport).with_ef_slots(3)
    p, jp = _torch(params), jax.tree.map(jnp.asarray, params)
    s, js = t.init_state(p), jt.init_state(jp)
    for _ in range(3):
        stack = {k: v[None] + rng.normal(size=(3,) + v.shape).astype(
            np.float32) * 0.01 for k, v in _np(jp).items()}
        p, s = t.aggregate(None, _torch(_np(jp)), _torch(stack),
                           torch.tensor(w), to_port_state(js))
        jp, js = jt.aggregate(None, jp, jax.tree.map(jnp.asarray, stack),
                              jnp.asarray(w), js)
        for k in params:
            assert s[k].shape == (3,) + params[k].shape
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-6, atol=1e-7)


def _femnist_trainer(sampler, aggregator="mean", transport="int8",
                     cohort=None):
    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=12, samples_per_client=20)
    fed = FedConfig(total_clients=12, clients_per_round=4, rounds=2, k0=2,
                    eta0=0.3, batch_size=4, loss_window=3,
                    transport=transport, sampler=sampler,
                    aggregator=aggregator, cohort=cohort)
    return FedAvgTrainer(lambda p, b: small.task_loss(p, task, b),
                         small.init_task_model(0, task, device="cpu"), data,
                         fed, RuntimeModel(task.model_size_mb, task.runtime,
                                           4), device="cpu")


def test_fixed_cohort_trainer_switches_to_per_client_ef():
    tr = _femnist_trainer("fixed_cohort")
    assert tr.engine.transport.ef_slots == 4
    h = tr.run(2)
    assert np.isfinite(h.train_loss).all()
    assert {v.shape[0] for v in tr.engine.transport_state.values()
            for v in v.values()} == {4}
    # uniform sampling keeps the aggregate residual; int8x2 has none
    assert _femnist_trainer("uniform").engine.transport.ef_slots is None
    assert _femnist_trainer("fixed_cohort", transport="int8x2") \
        .engine.transport.ef_slots is None


def test_weight_riding_samplers_refuse_robust_aggregators():
    for name in ("availability", "population"):
        with pytest.raises(ValueError, match="weight-respecting"):
            _femnist_trainer(name, aggregator="median")


@pytest.mark.parametrize("cohort", [(0, 1, 2), (0, 1, 2, 3, 4), (0, 1, 2, 14)])
def test_fixed_cohort_refuses_a_wrong_cohort_as_the_reference(data, cohort):
    """A cohort of another size than the round's, or with an id past the
    population, raises at the draw in both packages; as a trainer's
    sampler it raises at the first round."""
    port = sampling.FixedCohortSampler(cohort)
    ref = jsampling.FixedCohortSampler(cohort)
    for s in (port, ref):
        with pytest.raises(ValueError, match="cohort"):
            s.round(np.random.default_rng(0), data, 4, round_idx=1)
    if len(cohort) != 4:
        tr = _femnist_trainer("fixed_cohort", cohort=cohort)
        with pytest.raises(ValueError, match="fixed cohort has"):
            tr.run(1)


def test_mesh_backend_refuses_slotted_error_feedback():
    """The refusal this test pinned is gone: per-client error feedback runs
    on the MeshBackend (ROADMAP A13 (a); tests/test_torch_sequential.py
    holds it on 1, 2 and 4 ranks). A slotted codec builds a round core on
    both strategies; slots that the sequential groups do not divide are
    refused by name."""
    t = transport.TopKTransport(0.25).with_ef_slots(4)
    for strategy in ("parallel", "sequential"):
        backend = MeshBackend(None, strategy=strategy, device="cpu")
        assert callable(backend.make_round_core(lambda p, b: None,
                                                transport=t))
    slots = {"w": torch.zeros(4, 2)}
    with pytest.raises(ValueError, match="4 clients not divisible into 3"):
        MeshBackend(None, strategy="sequential", groups=3,
                    device="cpu").place_transport_state(slots,
                                                        per_client=True)


# ---------------------------------------------------------------------------
# fixed-cohort-topk
# ---------------------------------------------------------------------------

def test_fixed_cohort_topk_spec_matches_reference():
    """``fixed-cohort-topk`` for 3 rounds: the cohort every round, counters
    exact, slotted residuals in both trainers, losses allclose."""
    rounds = 3
    spec = lm_spec("fixed-cohort-topk", f"fed.rounds={rounds}")
    jtr, tr, init, jids, ids = lm_trainers(spec)
    assert tr.engine.transport.ef_slots == \
        jtr.engine.transport.ef_slots == 4
    jh, h = jtr.run(rounds), tr.run(rounds)
    assert_counters_equal(h, jh, ids, jids, rounds)
    assert ids == [[0, 3, 5, 9]] * rounds
    np.testing.assert_allclose(h.train_loss, jh.train_loss, rtol=LOSS_RTOL)
    got, want = flat(tr.engine.transport_state), \
        flat(jtr.engine.transport_state)
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape and got[k].shape[0] == 4
               for k in want)


# a top-k selection flips where two magnitudes tie within the packages'
# ~1e-7 noise: in one slot of one leaf, a coordinate that one package
# keeps the other leaves in its residual, and the other way round. At
# most two such swaps a slot and leaf in a round (the readings over 3
# rounds of 14 leaves x 4 slots: 3, 2 and 4 swaps a round, at most two in
# one leaf).
FLIP_POSITIONS = 4


def _flips(got, want, scale):
    """Positions beyond TOL; each must be a tie at the top-k threshold:
    its difference no larger than ``scale`` (the slot's largest residual
    magnitude, i.e. the largest value it did not ship) within TOL."""
    bad = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
    d = np.abs(got - want)[bad]
    assert (d <= scale * (1 + TOL["rtol"]) + TOL["atol"]).all(), \
        (d.max(), scale)
    return int(bad.sum())


def test_fixed_cohort_topk_rounds_from_reference_state():
    """Each of 3 rounds of ``fixed-cohort-topk``'s engine, started from the
    reference engine's params and residual slots before that round: first
    losses allclose; every residual slot allclose but for at most
    ``FLIP_POSITIONS`` top-k ties, and the params but for the same ties
    weighted into the aggregate (ROADMAP C5)."""
    from repro.configs import get_arch as jget_arch
    from repro.core.engine import RoundEngine as JEngine
    from repro.data import make_lm_clients
    from repro.models import registry as jregistry
    jcfg, cfg = (jget_arch("qwen1.5-0.5b-reduced"),
                 get_arch("qwen1.5-0.5b-reduced"))
    data = make_lm_clients(np.random.default_rng(0), 12, cfg.vocab_size, 32)
    jloss, tloss = jregistry.loss_fn(jcfg), registry.loss_fn(cfg)
    jeng = JEngine(lambda p, b: jloss(p, {"tokens": b["x"]}),
                   transport=jtransport.get_transport(
                       "topk", topk_frac=0.25).with_ef_slots(4))
    teng = RoundEngine(lambda p, b: tloss(p, {"tokens": b["x"]}),
                       transport=transport.get_transport(
                           "topk", topk_frac=0.25).with_ef_slots(4),
                       device="cpu")
    jp = jregistry.init(jax.random.PRNGKey(0), jcfg)
    jeng.init_transport_state(jp)
    rng = np.random.default_rng(0)
    cohort = sampling.FixedCohortSampler([0, 3, 5, 9])
    flips = []
    for r, k in enumerate([6, 5, 5]):
        bb = pipeline.bucket_batches(rng, data, n_rounds=1, k=k,
                                     clients_per_round=4, batch_size=4,
                                     sampler=cohort, round_ids=[r + 1])
        before = (_np(jp), jeng.transport_state)
        jp, jf, _, _ = jeng.run_bucket(jp, bb.batches, bb.weights,
                                       np.full(1, 0.05, np.float32),
                                       np.ones(1, bool), ())
        teng.transport_state = to_port_state(before[1])
        tp, tf, _, _ = teng.run_bucket(
            _torch(before[0]), bb.batches, bb.weights,
            np.full(1, 0.05, np.float32), np.ones(1, bool), ())
        np.testing.assert_allclose(tf.numpy()[0], np.asarray(jf)[0], **TOL)
        got, want = flat(teng.transport_state), flat(jeng.transport_state)
        pg, pw = flat(tp), flat(jp)
        for key in want:
            scales = [max(np.abs(want[key][j]).max(),
                          np.abs(got[key][j]).max()) for j in range(4)]
            n = [_flips(got[key][j], want[key][j], scales[j])
                 for j in range(4)]
            assert max(n) <= FLIP_POSITIONS, (r, key, n)
            flips.append(sum(n))
            w = bb.weights[0]
            assert _flips(pg[key], pw[key],
                          max(wj * s for wj, s in zip(w, scales))) \
                <= FLIP_POSITIONS * 4, (r, key)
    assert sum(flips) <= len(flips)       # ties are rare, not the rule
