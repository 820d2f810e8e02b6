"""The port's multi-device round on ``torch.distributed`` (gloo on the CPU):
the client-sharded kernels, ``MeshBackend`` and ``FedAvgTrainer`` on it.

  * in this process, a world of one rank: each sharded function against
    the reference's sharded kernel (interpret mode) on the host meshes,
    flat and grouped; ``MeshBackend`` bitwise against ``LocalBackend`` (a
    mesh of one rank is the local round); the mesh trainer against the
    reference's ``LocalBackend`` trainer (the reference's own MeshBackend
    fails under this JAX, ROADMAP queue C6); refusals;
  * spawned worlds of 2 ranks ((2, 1) data x model) and 4 ranks ((2, 2)
    pod x data), 25 client rows spread unevenly: each sharded function
    within 1e-6 of the unsharded plain version (bf16: one bf16 ulp), the
    trainer against the one-rank run, the codec pairs round by round, and
    every rank holding the same result. The ranks run
    ``tests/test_torch_mesh_ranks.py`` and import no JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import FedConfig as JFed
from repro.core import FedAvgTrainer as JTrainer
from repro.core import RuntimeModel as JRuntime
from repro.kernels import delta_codec as jdc
from repro.kernels import fedavg_reduce as jfr
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.models import small as jsmall
from repro_torch.configs import FedConfig, get_paper_task
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.core.engine.backends import (BACKENDS, LocalBackend,
                                              MeshBackend, get_backend)
from repro_torch.core.engine.round import RoundEngine
from repro_torch.data import pipeline
from repro_torch.kernels import collectives, ops
from repro_torch.kernels import delta_codec as tdc
from repro_torch.kernels import fedavg_reduce as tfr
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import small
from test_torch_mesh_ranks import (MESHES, N_ROWS, TRAINER_RUNS, WIRE_PAIRS,
                                   kernel_inputs, rank_body, run_trainer,
                                   sharded_outputs, spawn, unsharded_outputs)
from test_torch_parity_helpers import (TOL, _torch, assert_trees_close,
                                       flat, small_setup, trees_equal)

# tests/test_kernels.py:12 (f32); tests/test_kernels.py:279-312 between
# groupings and shardings of one sum
KTOL = dict(rtol=2e-4, atol=2e-4)
SHARD_ATOL = 1e-6
# bf16 output: the f32 sum rounded once, in another order than the plain
# version's: one bf16 ulp apart at most
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo process group of one rank in this process, for the module."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes(world1):
    """The host meshes of the reference's tests, port and reference side:
    1x1 ("data", "model") and 1x1 ("pod", "data")."""
    return {"host": (make_host_mesh("cpu"), jmake_host_mesh(), ("data",)),
            "pod_data": (make_mesh((1, 1), ("pod", "data"), "cpu"),
                         jax.make_mesh((1, 1), ("pod", "data")),
                         ("pod", "data"))}


# ---------------------------------------------------------------------------
# the sharded kernels against the reference's, one rank
# ---------------------------------------------------------------------------

def _jax(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("reduce", ["flat", "grouped"])
@pytest.mark.parametrize("mesh_name", ["host", "pod_data"])
def test_sharded_kernels_match_reference_sharded(meshes, mesh_name, reduce):
    tmesh, jmesh, axes = meshes[mesh_name]
    tiers = (tuple((a,) for a in reversed(axes)) if reduce == "grouped"
             else None)
    got = sharded_outputs(tmesh, axes, tiers)
    a = kernel_inputs()
    kw = dict(mesh=jmesh, client_axes=axes, interpret=True,
              reduce_tiers=tiers)
    want = {
        "fedavg": jfr.fedavg_reduce_sharded(_jax(a["x"]), _jax(a["w"]),
                                            **kw),
        "fedavg.bf16": jfr.fedavg_reduce_sharded(
            _jax(a["x"]).astype(jnp.bfloat16), _jax(a["w"]), **kw),
        "int8": jdc.int8_decompress_reduce_sharded(
            _jax(a["q"]), _jax(a["w_eff"]), **kw),
        "int8x2": jdc.int8_decompress_reduce_sharded(
            _jax(a["q"]), _jax(a["w_eff"]), _jax(a["qr"]),
            _jax(a["wr_eff"]), **kw),
        "topk": jdc.topk_scatter_reduce_sharded(
            _jax(a["vals"]), _jax(a["idx"]), _jax(a["w"]), a["ref"].size,
            **kw),
        "apply": jdc.int8_decode_apply_sharded(
            _jax(a["ref"]), _jax(a["q"][0]), _jax(a["s"]), mesh=jmesh,
            axes=axes, interpret=True),
        "apply2": jdc.int8_decode_apply_sharded(
            _jax(a["ref"]), _jax(a["q"][0]), _jax(a["s"]),
            _jax(a["qr"][0]), _jax(a["rs"]), mesh=jmesh, axes=axes,
            interpret=True),
    }
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == tuple(w.shape), k
        tol = dict(rtol=3e-2, atol=3e-2) if "bf16" in k else KTOL
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), err_msg=k,
                                   **tol)
    assert got["fedavg.bf16"].dtype == torch.bfloat16


def test_sharded_kernels_at_one_rank_equal_unsharded_bitwise(meshes):
    """One rank holds every row: each sharded function is its unsharded
    plain version, bit for bit, and so is its plain sharded version."""
    tmesh, _, axes = meshes["pod_data"]
    want = unsharded_outputs()
    for plain in (False, True):
        got = sharded_outputs(tmesh, axes, None, plain=plain)
        for k in want:
            assert torch.equal(got[k], want[k]), (k, plain)


def test_all_reduce_tiers_refuses_what_psum_tiers_refuses(meshes):
    tmesh = meshes["pod_data"][0]
    for tiers in [(("data",),), (("data",), ("pod", "data"))]:
        with pytest.raises(ValueError) as jexc:
            jfr.psum_tiers(jnp.zeros(4), ("pod", "data"), tiers)
        with pytest.raises(ValueError) as texc:
            collectives.all_reduce_tiers(torch.zeros(4), tmesh,
                                         ("pod", "data"), tiers)
        assert str(texc.value) == str(jexc.value)


def test_fedavg_reduce_f32_output_and_sharded_ops_on_cpu(meshes):
    """The f32-output reduce (a bf16 stack's partial) is its plain version
    on the CPU; the tree and ops entry points reach the sharded wrappers;
    a rank with no rows adds zeros and launches nothing."""
    tmesh, _, axes = meshes["host"]
    a = kernel_inputs()
    x = torch.tensor(a["x"]).to(torch.bfloat16)
    w = torch.tensor(a["w"])
    out = tfr.fedavg_reduce(x, w, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert torch.equal(out, tref.fedavg_reduce_ref(x, w, torch.float32))
    with pytest.raises(TypeError):
        tfr.fedavg_reduce(x.float(), w, out_dtype=torch.bfloat16)
    tree = {"a": torch.tensor(a["x"]).reshape(N_ROWS, 10, 100),
            "b": {"c": torch.tensor(a["x"][:, :7])}}
    got = ops.fedavg_reduce_tree_sharded(tree, w, mesh=tmesh,
                                         client_axes=axes)
    assert torch.equal(got["a"], ops.fedavg_reduce_tree(tree, w)["a"])
    assert torch.equal(got["b"]["c"], tref.fedavg_reduce_ref(tree["b"]["c"],
                                                             w))
    before = (tfr.sharded_launches, dict(tdc.sharded_launches))
    empty = tfr.fedavg_reduce_sharded(torch.zeros((0, 9)), torch.zeros(0),
                                      mesh=tmesh, client_axes=axes)
    assert torch.equal(empty, torch.zeros(9))
    assert ops.int8_delta_reduce_sharded(
        torch.zeros((0, 9), dtype=torch.int8), torch.zeros(0), mesh=tmesh,
        client_axes=axes).shape == (9,)
    assert (tfr.sharded_launches, dict(tdc.sharded_launches)) == before


def test_row_range_splits_contiguously_and_unevenly():
    for n, size in [(25, 2), (25, 4), (5, 4), (8, 4), (3, 3)]:
        blocks = [collectives.row_range(n, size, r) for r in range(size)]
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        lens = [hi - lo for lo, hi in blocks]
        assert max(lens) - min(lens) <= 1 and lens == sorted(lens)[::-1]


# ---------------------------------------------------------------------------
# MeshBackend at one rank: bitwise LocalBackend, and against the reference
# ---------------------------------------------------------------------------

def _trainer(name, params, data, fed, backend=None):
    task = get_paper_task(name)
    return FedAvgTrainer(lambda p, b: small.task_loss(p, task, b),
                         _torch(params), data, fed,
                         RuntimeModel(task.model_size_mb, task.runtime,
                                      fed.clients_per_round),
                         device="cpu", backend=backend)


# as tests/test_backends.py:70-76
AGG_SETTINGS = [dict(aggregator="mean"), dict(aggregator="kernel"),
                dict(aggregator="trimmed_mean", server_optimizer="fedavgm",
                     server_lr=0.5),
                dict(aggregator="median", server_optimizer="fedyogi",
                     server_lr=0.1)]


@pytest.mark.parametrize("fed_kw", AGG_SETTINGS,
                         ids=lambda kw: kw["aggregator"])
def test_mesh_backend_one_rank_bitwise_equals_local(meshes, fed_kw):
    task, params, data = small_setup("femnist")
    fed = FedConfig(total_clients=8, clients_per_round=4, rounds=5, k0=3,
                    eta0=0.3, batch_size=4, k_schedule="rounds", seed=1,
                    **fed_kw)
    local = _trainer("femnist", params, data, fed)
    hl = local.run(5)
    for mesh_name, reduce in [("host", "flat"), ("pod_data", "grouped")]:
        mesh = _trainer("femnist", params, data, fed,
                        MeshBackend(meshes[mesh_name][0], reduce=reduce))
        hm = mesh.run(5)
        assert trees_equal(mesh.params, local.params), mesh_name
        assert hm.train_loss == hl.train_loss
        assert (hm.k, hm.sgd_steps, hm.wall_clock_s) == \
            (hl.k, hl.sgd_steps, hl.wall_clock_s)


@pytest.mark.parametrize("up,down", WIRE_PAIRS)
def test_mesh_wire_pairs_one_rank_bitwise_equal_local(meshes, up, down):
    """The bound codecs (sharded reduce, all-reduced error feedback, sharded
    decode-apply) at one rank: the local round, bit for bit."""
    task, params, data = small_setup("femnist", seed=2)
    fed = FedConfig(total_clients=8, clients_per_round=4, rounds=3, k0=3,
                    eta0=0.3, batch_size=4, k_schedule="rounds", seed=1,
                    aggregator="kernel", transport=up, downlink=down)
    local = _trainer("femnist", params, data, fed)
    hl = local.run(3)
    mesh = _trainer("femnist", params, data, fed,
                    MeshBackend(meshes["pod_data"][0], reduce="grouped"))
    before = dict(tdc.sharded_launches)
    hm = mesh.run(3)
    assert trees_equal(mesh.params, local.params)
    assert (hm.train_loss, hm.uplink_mbit, hm.downlink_mbit) == \
        (hl.train_loss, hl.uplink_mbit, hl.downlink_mbit)
    # on the CPU the wrappers run their plain versions: no launch counted
    assert tdc.sharded_launches == before


@pytest.mark.parametrize("aggregator", ["kernel", "mean"])
def test_mesh_trainer_matches_reference_local_trainer(meshes, aggregator):
    """K_r, client ids, sgd_steps, wall clock and wire exact; losses and
    params allclose (``tests/test_torch_trainer.py``'s tolerances)."""
    task, params, data = small_setup("cifar100")
    kw = dict(total_clients=8, clients_per_round=4, rounds=3, k0=4,
              eta0=task.fed.eta0, batch_size=4, k_schedule="rounds",
              aggregator=aggregator, seed=0)
    jtr = JTrainer(lambda p, b: jsmall.task_loss(p, task, b),
                   jax.tree.map(jnp.asarray, params), data, JFed(**kw),
                   JRuntime(task.model_size_mb, task.runtime, 4))
    jids, tids = [], []
    jtr.sampler.round = _recording(jtr.sampler.round, jids)
    jh = jtr.run(3)
    tr = _trainer("cifar100", params, data, FedConfig(**kw),
                  MeshBackend(meshes["host"][0]))
    tr.sampler.round = _recording(tr.sampler.round, tids)
    h = tr.run(3)
    assert tids == jids and len(tids) == 3
    assert (h.rounds, h.k, h.eta, h.sgd_steps, h.wall_clock_s,
            h.uplink_mbit, h.downlink_mbit) == \
        (jh.rounds, jh.k, jh.eta, jh.sgd_steps, jh.wall_clock_s,
         jh.uplink_mbit, jh.downlink_mbit)
    np.testing.assert_allclose(h.train_loss, jh.train_loss, rtol=1e-4)
    assert_trees_close(tr.params, jtr.params, **TOL)


def _recording(fn, ids):
    def round_(*a, **kw):
        out = fn(*a, **kw)
        ids.append(np.asarray(out[0]).tolist())
        return out
    return round_


def test_engine_places_this_ranks_rows_idempotently(meshes):
    """Host arrays are the whole cohort and get sliced; placed tensors pass
    through; the default mesh backend spans every rank."""
    backend = MeshBackend(meshes["host"][0])
    task, params, data = small_setup("femnist")
    bb = pipeline.bucket_batches(np.random.default_rng(0), data, n_rounds=1,
                                 k=2, clients_per_round=3, batch_size=4)
    placed = backend.place_bucket(bb)
    assert backend.place_bucket(placed) is not None
    again = backend.place_batches({k: v[0] for k, v in
                                   placed.batches.items()})
    for k, v in placed.batches.items():
        assert torch.equal(again[k], v[0]) and v.shape[1] == 3
    assert torch.equal(backend.place_weights(placed.weights[0]),
                       placed.weights[0])
    sliced = pipeline.slice_clients(bb, 1, 3)
    assert sliced.weights.shape == (1, 2)
    assert np.array_equal(sliced.batches["x"], bb.batches["x"][:, 1:3])
    default = get_backend("mesh", device="cpu")
    assert isinstance(default, MeshBackend)
    assert default.mesh.mesh_dim_names == ("data", "model")
    assert tuple(default.mesh.shape) == (1, 1)
    assert isinstance(get_backend("local", device="cpu"), LocalBackend)
    assert get_backend(backend) is backend and set(BACKENDS) == {"local",
                                                                 "mesh"}
    eng = RoundEngine(lambda p, b: small.task_loss(
        p, get_paper_task("femnist"), b), backend=backend)
    assert eng.device == torch.device("cpu") and eng.backend is backend


def test_refusals_name_the_field(meshes):
    tmesh = meshes["host"][0]
    with pytest.raises(ValueError, match="strategy"):
        MeshBackend(tmesh, strategy="ring")
    with pytest.raises(ValueError, match="'model'.*A13 \(b\)"):
        make_mesh((1, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="param_specs.*A13 \(b\)"):
        MeshBackend(tmesh, strategy="sequential", param_specs={})
    with pytest.raises(ValueError, match="reduce"):
        MeshBackend(tmesh, reduce="ring")
    with pytest.raises(NotImplementedError, match="cohort_chunk.*A13"):
        MeshBackend(tmesh).make_slab_cores(None)
    with pytest.raises(NotImplementedError, match="carve_submeshes"):
        MeshBackend(tmesh).fleet_slices(2)
    task, params, data = small_setup("femnist")
    # streaming cohorts and the async engine wait for ROADMAP A13 on a mesh
    fed = FedConfig(total_clients=8, clients_per_round=4, cohort_chunk=2)
    with pytest.raises(NotImplementedError, match="cohort_chunk.*A13"):
        _trainer("femnist", params, data, fed, MeshBackend(tmesh))
    from repro_torch.core.engine import AsyncBufferedEngine
    fed = FedConfig(total_clients=8, clients_per_round=4,
                    aggregation="async")
    with pytest.raises(ValueError, match="MeshBackend.*A13"):
        ttask = get_paper_task("femnist")
        AsyncBufferedEngine(lambda p, b: small.task_loss(p, ttask, b),
                            _torch(params), data, fed,
                            RuntimeModel(1.0, ttask.runtime, 4),
                            backend=MeshBackend(tmesh))
    with pytest.raises(ValueError, match="device"):
        RoundEngine(lambda p, b: 0.0, backend=MeshBackend(tmesh),
                    device="cuda")


# ---------------------------------------------------------------------------
# spawned worlds of 2 and 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return spawn(rank_body, 2, tmp_path_factory.mktemp("w2"), True, True)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return spawn(rank_body, 4, tmp_path_factory.mktemp("w4"), True, False)


def _within_plain(results):
    want = unsharded_outputs()
    for res in results:
        for key in ("kernels.flat", "kernels.grouped", "plain.flat",
                    "plain.grouped"):
            for k, w in want.items():
                g = res[key][k]
                assert g.dtype == w.dtype and g.shape == w.shape, (key, k)
                if k.startswith("apply"):        # elementwise: exact
                    assert torch.equal(g, w), (key, k)
                elif "bf16" in k:
                    torch.testing.assert_close(g.float(), w.float(),
                                               **BF16_TOL)
                else:
                    assert float((g - w).abs().max()) <= SHARD_ATOL, (key, k)
        got, whole = res["apply_odd"]
        assert torch.equal(got, whole)
        assert "not a multiple" in res["apply_odd_refused"]


def _ranks_agree(results):
    """Every rank holds the same sums, gathers and trained params."""
    first = results[0]
    for res in results[1:]:
        for key, val in res.items():
            if key in ("rank", "rows", "counts"):
                continue
            a, b = _leaves(first[key]), _leaves(val)
            assert len(a) == len(b) and all(
                torch.equal(x, y) for x, y in zip(a, b)), key


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    if hasattr(x, "train_loss"):                      # a History
        return [torch.tensor(x.train_loss), torch.tensor(x.wall_clock_s)]
    return []


def _trainers_match_one_rank(results, reduces):
    for name, kw in TRAINER_RUNS.items():
        want_p, want_h = run_trainer(None, **kw)
        for reduce in reduces:
            got_p, got_h = results[0][f"trainer.{reduce}.{name}"]
            assert (got_h.k, got_h.sgd_steps, got_h.wall_clock_s,
                    got_h.uplink_mbit) == (want_h.k, want_h.sgd_steps,
                                           want_h.wall_clock_s,
                                           want_h.uplink_mbit)
            np.testing.assert_allclose(got_h.train_loss, want_h.train_loss,
                                       rtol=1e-5, err_msg=name)
            assert_trees_close(got_p, want_p, rtol=1e-5, atol=1e-5)


def test_two_ranks_sharded_kernels_within_1e6_of_plain(ranks2):
    assert [r["rows"] for r in ranks2] == [(0, 13), (13, 25)]
    _within_plain(ranks2)


def test_two_ranks_trainer_matches_one_rank(ranks2):
    _trainers_match_one_rank(ranks2, ("flat", "grouped"))


def test_two_ranks_wire_pairs_round_by_round(ranks2):
    """Each round from the local engine's state: int8 within one
    quantisation step of the round's movement (the sum order across ranks
    moves values near a rounding boundary, as in
    ``tests/test_torch_transport.py``), top-k allclose."""
    for up, down in WIRE_PAIRS:
        for r, (before, want, got) in enumerate(
                ranks2[0][f"wire.{up}/{down}"]):
            fg, fw, fb = flat(got), flat(want), flat(before)
            for k in fw:
                g, w, b = fg[k], fw[k], fb[k]
                if up == "topk":
                    np.testing.assert_allclose(g, w, **TOL)
                    continue
                step = float(np.max(np.abs(w - b))) / 127.0
                diff = np.abs(g - w)
                assert diff.max() <= TOL["atol"] + step, (up, r, k)
                assert diff.mean() <= TOL["atol"] / 10 + step / 20, (up, r, k)


def test_two_ranks_agree_bitwise(ranks2):
    _ranks_agree(ranks2)


def test_four_ranks_sharded_kernels_within_1e6_of_plain(ranks4):
    assert [r["rows"] for r in ranks4] == [(0, 7), (7, 13), (13, 19),
                                           (19, 25)]
    _within_plain(ranks4)


def test_four_ranks_trainer_matches_one_rank_flat_and_grouped(ranks4):
    _trainers_match_one_rank(ranks4, ("flat", "grouped"))
    assert MESHES[4][1] == ("pod", "data")


def test_four_ranks_agree_bitwise(ranks4):
    _ranks_agree(ranks4)
