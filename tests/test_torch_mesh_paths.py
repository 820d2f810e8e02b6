"""Streaming cohorts, the async engine and fleet sub-meshes on the port's
``MeshBackend`` (the parallel strategy), against the reference.

  * ``carve_grid`` (the rank grid of ``carve_submeshes``) against the
    reference's ``carve_submeshes`` on the duck meshes of
    ``tests/test_fleet.py``; ``carve_submeshes`` and ``fleet_slices`` on
    a world of one rank;
  * in this process, a world of one rank: streamed rounds (C in {1, 3,
    U} for the plain, kernel, int8 and top-k paths) bitwise the port's
    ``LocalBackend`` slabs, and within ``tests/test_streaming.py``'s
    tolerances of the reference's ``LocalBackend`` chunked runs from the
    same initial params (the reference's own mesh runs fail under this
    JAX, ROADMAP queue C6, so a 1x1 mesh is held to local); the async
    engine bitwise ``LocalBackend``'s;
  * spawned worlds of 2 ranks ((2, 1) data x model) and 4 ranks ((2, 2)
    pod x data, grouped reduce): streamed rounds whose tail slab is
    smaller than the world, every rank alike bit for bit, near the
    one-rank run, and a rank without a row of a slab calling no kernel;
    FSDP streamed rounds and async runs bitwise their replicated twins;
    async runs (one resumed from a mid-buffer checkpoint) bitwise the
    one-rank run; a packed fleet of 4 points on 2 slices of 2, each
    point bitwise itself run alone on a 2-rank mesh, with exact counts
    and program keys that carry the slice's ranks. The ranks run
    ``tests/test_torch_mesh_ranks.py`` and import no JAX.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.api import ExperimentSpec as JSpec
from repro.api.experiment import build as jbuild
from repro.core.engine.backends.mesh import carve_submeshes as jcarve
from repro_torch.api import ExperimentSpec, build
from repro_torch.core.engine.backends import LocalBackend, MeshBackend
from repro_torch.core.engine.backends.mesh import (carve_grid,
                                                   carve_submeshes)
from repro_torch.launch.mesh import make_mesh
from test_torch_mesh_ranks import (ASYNC_APPLIES, MESHES, SLAB_C,
                                   SLAB_RUNS, SLAB_SHARDED, async_engine,
                                   async_result, femnist_setup,
                                   paths_rank_body, run_async, run_slabs,
                                   spawn)
from test_torch_parity_helpers import TOL, _torch, flat, trees_equal
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

COHORT = 6
# tests/test_streaming.py:84: the plain fold's and the codecs' tolerances
STREAM_TOL = {"none": 1e-6, "int8": 2e-3, "topk": 2e-3}
SLAB_CONFIGS = [("none", "uniform", "mean"), ("none", "uniform", "kernel"),
                ("int8", "uniform", "mean"), ("int8", "fixed_cohort", "mean"),
                ("topk", "fixed_cohort", "mean")]
SHARD_ATOL = 1e-6


class CarveMesh:
    """Duck-typed mesh with a device grid (``tests/test_fleet.py:225``)."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A gloo process group of one rank in this process, for the module,
    and its 1x1 ("data", "model") mesh."""
    path = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    yield make_mesh((1, 1), ("data", "model"), "cpu")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# carving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,n,slices", [((4, 2), 4, 4), ((6, 1), 4, 3),
                                            ((1, 1), 4, 1)])
def test_carve_grid_matches_the_reference(shape, n, slices):
    """The same slices, rank for rank: the largest axis cut into the
    largest divisor <= n (4 of (1, 2); 4 does not divide 6, so 3 of
    (2, 1)); one device, the mesh itself."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    want = jcarve(CarveMesh(grid, ("data", "model")), n)
    got = carve_grid(grid, n)
    assert len(got) == len(want) == slices
    assert [g.tolist() for g in got] == [w.devices.tolist() for w in want]
    assert sorted(r for g in got for r in g.reshape(-1)) == \
        list(range(grid.size))


def test_carve_submeshes_on_one_rank_is_the_mesh(mesh1):
    """On a world of one rank there is one slice, the mesh itself
    (the reference's ``[mesh]``), and ``fleet_slices`` cycles it with the
    backend's configuration."""
    assert carve_submeshes(mesh1, 4) == [mesh1]
    be = MeshBackend(mesh1, reduce="grouped", acc_dtype=torch.bfloat16)
    slices = be.fleet_slices(3)
    assert len(slices) == 3 and all(s.mesh is mesh1 for s in slices)
    assert all((s.strategy, s.reduce, s.acc_dtype, s.groups,
                s.client_axes) == ("parallel", "grouped", torch.bfloat16,
                                   1, ("data",)) for s in slices)


# ---------------------------------------------------------------------------
# one rank: streamed rounds against local and the reference
# ---------------------------------------------------------------------------

def _spec(chunk, transport, sampler, aggregator, rounds=2):
    d = {"data": {"kind": "paper", "task": "femnist", "clients": 12,
                  "samples_per_client": 8, "seed": 0},
         "fed": {"clients_per_round": COHORT, "rounds": rounds, "k0": 2,
                 "eta0": 0.3, "batch_size": 4, "eval_every": 0,
                 "aggregator": aggregator, "bucket_rounds": 2,
                 "loss_window": 3, "seed": 0, "cohort_chunk": chunk},
         "transport": {"name": transport}, "sampler": {"name": sampler}}
    if sampler == "fixed_cohort":
        d["sampler"]["cohort"] = list(range(COHORT))
    return d


def _port_run(d, backend, init):
    exp = build(ExperimentSpec.from_dict(d), backend=backend, device="cpu")
    exp.trainer.params = _torch(init)
    exp.run()
    return exp


@pytest.mark.parametrize("chunk", [1, 3, COHORT])
@pytest.mark.parametrize("config", SLAB_CONFIGS, ids="-".join)
def test_one_rank_slabs_bitwise_local_and_near_the_reference(mesh1, config,
                                                             chunk):
    """A 1x1 mesh's streamed run is the port's local one bit for bit
    (params, codec state, counts); both start from the reference's params
    and end within ``tests/test_streaming.py``'s tolerance of its local
    chunked run (measured: <= 1.8e-7 plain, <= 6.3e-4 int8, 1e-7
    top-k)."""
    d = _spec(chunk, *config)
    jexp = jbuild(JSpec.from_dict(d))
    init = jax.tree.map(np.asarray, jexp.params)
    jh = jexp.run()
    mesh = _port_run(d, MeshBackend(mesh1), init)
    local = _port_run(d, LocalBackend("cpu"), init)
    assert trees_equal(mesh.params, local.params)
    assert _same(mesh.trainer.engine.transport_state,
                 local.trainer.engine.transport_state)
    assert mesh.history.as_dict() == local.history.as_dict()
    tr, lt = mesh.trainer, local.trainer
    assert (tr.compile_count, tr.dispatch_count) == (lt.compile_count,
                                                     lt.dispatch_count)
    assert mesh.history.k == jh.k and mesh.history.sgd_steps == jh.sgd_steps
    fj, fp = flat(jexp.params), flat(mesh.params)
    assert max(float(np.max(np.abs(fj[k] - fp[k]))) for k in fj) <= \
        STREAM_TOL[config[0]]


def test_one_rank_async_bitwise_local(mesh1):
    """The async engine on a 1x1 mesh is ``LocalBackend``'s bit for bit:
    history, params, residual slots, staleness histogram and counts."""
    got = async_result(_ran(async_engine(MeshBackend(mesh1))))
    want = async_result(_ran(async_engine(LocalBackend("cpu"))))
    _same_async(got, want)


def _same(a, b) -> bool:
    """Two trees equal bit for bit; ``()`` (no state) only equals
    ``()``."""
    empty = lambda t: isinstance(t, tuple) and not t
    if empty(a) or empty(b):
        return empty(a) and empty(b)
    return trees_equal(a, b)


def _ran(eng):
    eng.run(ASYNC_APPLIES)
    return eng


def _same_async(got, want, counts=True):
    assert got["history"] == want["history"] and got["hist"] == want["hist"]
    for key in ("params", "t_state", "server"):
        assert _same(got[key], want[key]), key
    if counts:
        assert got["counts"] == want["counts"]


# ---------------------------------------------------------------------------
# spawned worlds of 2 and 4 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paths2")
    return spawn(paths_rank_body, 2, tmp, str(tmp))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paths4")
    return spawn(paths_rank_body, 4, tmp, str(tmp))


@pytest.fixture(scope="module")
def one_rank(mesh1, tmp_path_factory):
    """The one-rank runs the spawned ranks are held to."""
    out = {f"slabs.{c}.{name}": run_slabs(MeshBackend(mesh1), c, **kw)
           for c in set(SLAB_C.values()) for name, kw in SLAB_RUNS.items()}
    tmp = tmp_path_factory.mktemp("async1")
    out["async"] = run_async(MeshBackend(mesh1), str(tmp / "ck"))
    out["async.fedavgm"] = run_async(MeshBackend(mesh1), None,
                                     server_optimizer="fedavgm",
                                     server_lr=0.5)
    return out


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


def _ranks_alike(results, keys):
    for key in keys:
        first = _leaves(results[0][key])
        for res in results[1:]:
            other = _leaves(res[key])
            assert len(first) == len(other) and all(
                torch.equal(x, y) for x, y in zip(first, other)), key


def _near_one_rank(got, want, name):
    """The streamed run on W ranks against one rank's: the same counters
    and counts; params within 1e-6 (plain, kernel), within one int8 step
    of each leaf's movement over the run (the parallel round's int8 rule,
    ``tests/test_torch_mesh.py``), or allclose (top-k)."""
    hg, hw = got["history"], want["history"]
    assert (hg.k, hg.sgd_steps, hg.wall_clock_s, hg.uplink_mbit) == \
        (hw.k, hw.sgd_steps, hw.wall_clock_s, hw.uplink_mbit)
    assert got["counts"] == want["counts"]
    np.testing.assert_allclose(hg.train_loss, hw.train_loss, rtol=1e-5)
    init = flat(femnist_setup()[2])
    fg, fw = flat(got["params"]), flat(want["params"])
    assert sorted(fg) == sorted(fw)
    for k in fw:
        diff = np.abs(fg[k] - fw[k])
        if name in ("mean", "kernel"):
            assert diff.max() <= SHARD_ATOL, (name, k)
        elif name.startswith("topk"):
            np.testing.assert_allclose(fg[k], fw[k], **TOL, err_msg=k)
        else:
            step = float(np.max(np.abs(fw[k] - init[k]))) / 127.0
            assert diff.max() <= TOL["atol"] + step, (name, k)
            assert diff.mean() <= TOL["atol"] / 10 + step / 20, (name, k)


def _no_empty_launch(results, world):
    """Every kernel call on a rank's rows had a row; the ranks without a
    row of a slab made fewer calls (one a leaf a slab they hold rows
    of)."""
    u, c = 5, SLAB_C[world]
    slabs = [min(c, u - s) for s in range(0, u, c)]
    for name, kernel in (("kernel", "fedavg_reduce"),
                         ("int8", "int8_decompress_reduce"),
                         ("topk+slots", "topk_scatter_reduce")):
        leaves = len(_leaves(results[0][f"slabs.{name}"]["params"]))
        for r, res in enumerate(results):
            rows = res[f"rows.{name}"][kernel]
            held = sum(1 for s in slabs if r < s)
            assert all(n >= 1 for n in rows), (name, r, rows)
            assert len(rows) == held * leaves * 2, (name, r, len(rows))
        assert not results[0]["rows.mean"][kernel]


def test_two_ranks_streamed_rounds_alike_and_near_one_rank(ranks2, one_rank):
    """Slabs of 2, 2 and 1 over 2 ranks: the tail leaves rank 1 without a
    row."""
    _ranks_alike(ranks2, [f"slabs.{n}" for n in SLAB_RUNS])
    for name in SLAB_RUNS:
        _near_one_rank(ranks2[0][f"slabs.{name}"],
                       one_rank[f"slabs.{SLAB_C[2]}.{name}"], name)


def test_two_ranks_empty_tail_rank_calls_no_kernel(ranks2):
    _no_empty_launch(ranks2, 2)


def test_two_ranks_fsdp_slabs_bitwise_replicated(ranks2):
    """``param_specs`` over "data": params, codec state, server state,
    history and counts of the replicated twin bit for bit, at about half
    the params bytes a rank (the biases stay whole)."""
    _ranks_alike(ranks2, [f"fsdp.{t}.{n}" for t in ("plain", "sharded")
                          for n in SLAB_SHARDED])
    for name in SLAB_SHARDED:
        plain = ranks2[0][f"fsdp.plain.{name}"]
        sharded = ranks2[0][f"fsdp.sharded.{name}"]
        for key in ("params", "t_state", "server"):
            assert _same(sharded[key], plain[key]), (name, key)
        assert sharded["history"].as_dict() == plain["history"].as_dict()
        assert sharded["counts"] == plain["counts"]
        assert sharded["params_bytes"] < 0.51 * plain["params_bytes"]


def test_two_ranks_async_bitwise_one_rank(ranks2, one_rank):
    """Every rank runs the one-rank event loop: bitwise, counts too."""
    _ranks_alike(ranks2, ["async", "async.plain", "async.sharded"])
    _same_async(ranks2[0]["async"]["straight"],
                one_rank["async"]["straight"])
    _same_async(ranks2[0]["async.plain"]["straight"],
                one_rank["async.fedavgm"]["straight"])


def test_two_ranks_async_resumed_mid_buffer_bitwise(ranks2, one_rank):
    """Saved with a part-filled buffer, restored through ``place_params``
    and resumed: the uninterrupted run's history, params, slots and
    staleness histogram."""
    for res in (ranks2[0]["async"], ranks2[0]["async.sharded"],
                one_rank["async"]):
        assert res["mid"][0] > 0 and res["mid"][1] > 0
        _same_async(res["resumed"], res["ckpt_straight"], counts=False)
    _same_async(ranks2[0]["async"]["ckpt_straight"],
                one_rank["async"]["ckpt_straight"])


def test_two_ranks_async_fsdp_bitwise_replicated(ranks2):
    plain, sharded = ranks2[0]["async.plain"], ranks2[0]["async.sharded"]
    for key in ("straight", "resumed"):
        _same_async(sharded[key], plain[key])
    assert sharded["straight"]["params_bytes"] < \
        0.51 * plain["straight"]["params_bytes"]


def test_four_ranks_grouped_streamed_rounds_alike_and_near_one_rank(
        ranks4, one_rank):
    """Slabs of 3 and 2 over 4 ranks, reduced within each pod, then across
    pods: every slab leaves a rank without a row."""
    _ranks_alike(ranks4, [f"slabs.{n}" for n in SLAB_RUNS])
    for name in SLAB_RUNS:
        _near_one_rank(ranks4[0][f"slabs.{name}"],
                       one_rank[f"slabs.{SLAB_C[4]}.{name}"], name)
    assert MESHES[4][1] == ("pod", "data")


def test_four_ranks_empty_ranks_call_no_kernel(ranks4):
    _no_empty_launch(ranks4, 4)


def test_four_ranks_packed_fleet_equals_points_alone(ranks4):
    """4 points on 2 slices of (1, 2), cycled: every rank holds every
    point's row, equal to the point run alone on a 2-rank sub-mesh (loss
    and counts); each point's params bitwise the alone run's on the ranks
    that ran it."""
    rows = [r["fleet"]["points"] for r in ranks4]
    assert all(x == rows[0] for x in rows[1:])
    slices = ranks4[0]["fleet"]["slices"]
    assert slices == [[[0, 1]], [[2, 3]]]
    for res in ranks4:
        f = res["fleet"]
        assert f["own"] == slices[res["rank"] // 2]
        for label, k0, name, final, low, built, shared, disp in f["points"]:
            alone = f["alone"][k0, name]
            assert (final, low) == (alone["final_loss"], alone["min_loss"])
            assert (built + shared, disp) == alone["counts"]
        for key, mine in f["mine"].items():
            assert trees_equal(mine["params"], f["alone"][key]["params"])
        assert len(f["mine"]) == 2


def test_four_ranks_fleet_counts_and_keys_carry_the_ranks(ranks4):
    for res in ranks4:
        f = res["fleet"]
        built = sum(p[5] for p in f["points"])
        assert f["fleet_counts"] == (built, sum(p[6] for p in f["points"]),
                                     sum(p[7] for p in f["points"]))
        ranks = tuple(f["own"][0])
        for mine in f["mine"].values():
            assert mine["key"][-1] == ("ranks", ranks)
