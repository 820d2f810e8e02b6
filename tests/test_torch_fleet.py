"""The fleet runner (``repro_torch.launch.fleet``) and the backends' fleet
slices, against the reference's (``tests/test_fleet.py``: ``TestFleetDriver``
and ``TestFleetSlices``).

Packed runs equal serial runs bitwise (params, losses, history) and share
bucket programs; the leaderboard CSV has the reference's fields, and its
counters equal the reference's for the same sweep from the same initial
params, losses within the f32 tolerance. Every kernel wrapper's launch
counter stays exact under threads."""
import csv
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JSpec
from repro.api.sweep import expand_sweep as jexpand_sweep
from repro.launch import fleet as jfleet
from repro.models import small as jsmall
from repro_torch import bridge
from repro_torch.api import ExperimentSpec
from repro_torch.api.sweep import expand_sweep
from repro_torch.core.engine.backends import LocalBackend, MeshBackend
from repro_torch.kernels import _build
from repro_torch.kernels import delta_codec as dc
from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import fleet
from repro_torch.models import small
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

# tests/test_kernels.py's f32 tolerance, for losses across frameworks
KTOL = dict(rtol=2e-4, atol=2e-4)
# the reference's base spec (tests/test_fleet.py), at eta 0.05 where the
# losses are compared across frameworks (at 0.3 its DNN diverges)
BASE = ["data.kind=paper", "data.task=femnist", "data.clients=8",
        "data.samples_per_client=8", "fed.clients_per_round=4",
        "fed.rounds=2", "fed.batch_size=4", "fed.bucket_rounds=2",
        "fed.eta0=0.05"]
COUNTERS = ("label", "overrides", "rounds", "uplink_mbit", "downlink_mbit",
            "compiles", "shared", "dispatches")


def port_points(sweep, share=True):
    pts = expand_sweep(*sweep, base=ExperimentSpec().with_overrides(*BASE))
    return fleet.share_k_grid(pts) if share else pts


def ref_points(sweep, share=True):
    pts = jexpand_sweep(*sweep, base=JSpec().with_overrides(*BASE))
    return jfleet.share_k_grid(pts) if share else pts


@pytest.fixture
def reference_init(monkeypatch):
    """The port's ``build`` starts from the reference's initial params of
    the same seed (ROADMAP Known differences 12: the packages' streams
    differ), so losses compare across frameworks."""
    def init(seed, task, device=None):
        params = jsmall.init_task_model(jax.random.PRNGKey(seed), task)
        return bridge.params_from_jax(jax.tree.map(np.asarray, params),
                                      device=device)

    monkeypatch.setattr(small, "init_task_model", init)


@pytest.fixture
def recorded(monkeypatch):
    """{(k0, codec): experiment} of every point the port's fleet builds."""
    built = {}
    build = fleet.build

    def recording(spec, **kw):
        exp = build(spec, **kw)
        built[(spec.fed.k0, spec.transport.name)] = exp
        return exp

    monkeypatch.setattr(fleet, "build", recording)
    return built


def _bytes_equal(a, b):
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def test_packed_matches_serial_and_shares(recorded):
    """Two k0 points snapped to one bucket signature, and a codec axis:
    packed and serial build the same programs, share them alike, and every
    point's params, losses and history are bitwise the same."""
    sweep = ("fed.k0=15,16", "transport.name=none,int8")
    packed = fleet.run_fleet(points=port_points(sweep), packed=True,
                             device="cpu")
    runs = {"packed": dict(recorded)}
    recorded.clear()
    serial = fleet.run_fleet(points=port_points(sweep), packed=False,
                             device="cpu")
    runs["serial"] = dict(recorded)
    # one bucket signature a codec, each built once fleet-wide
    assert packed.compile_count == serial.compile_count == 2
    assert packed.shared_count == serial.shared_count == 2
    assert packed.dispatch_count == serial.dispatch_count == 4
    p = {r.label: r for r in packed.points}
    s = {r.label: r for r in serial.points}
    assert set(p) == set(s) and len(p) == 4
    for label in p:
        assert p[label].final_loss == s[label].final_loss
        assert p[label].dispatch_count == s[label].dispatch_count == 1
    for key, a in runs["packed"].items():
        b = runs["serial"][key]
        assert a.history.as_dict() == b.history.as_dict()
        for x, y in zip(bridge.params_to_numpy(a.params).values(),
                        bridge.params_to_numpy(b.params).values()):
            for k in x:
                assert _bytes_equal(torch.as_tensor(x[k]),
                                    torch.as_tensor(y[k]))
    assert isinstance(packed.points[0].peak_mb, float)


def test_leaderboard_and_csv_match_reference(tmp_path, reference_init):
    """The same sweep through both fleet runners from the same initial
    params: the CSV's fields are ``CSV_FIELDS`` (the reference's), its
    counters equal the reference's, its losses within the f32
    tolerance."""
    sweep = ("fed.k0=15,16",)
    res = fleet.run_fleet(points=port_points(sweep), packed=False,
                          device="cpu")
    jres = jfleet.run_fleet(points=ref_points(sweep), packed=False)
    board = res.leaderboard()
    assert "k0=15" in board and "k0=16" in board
    assert "fleet: 2 point(s)" in board and "1 compile(s), 1 shared" in board
    rows = {}
    for name, r in (("port", res), ("ref", jres)):
        out = tmp_path / f"{name}.csv"
        r.to_csv(str(out))
        with open(out) as f:
            rows[name] = {row["label"]: row for row in csv.DictReader(f)}
    assert fleet.CSV_FIELDS == jfleet.CSV_FIELDS
    assert set(rows["port"]) == set(rows["ref"]) == {"k0=15", "k0=16"}
    assert tuple(next(iter(rows["port"].values()))) == fleet.CSV_FIELDS
    for label, want in rows["ref"].items():
        got = rows["port"][label]
        assert {k: got[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
        np.testing.assert_allclose(
            [float(got["final_loss"]), float(got["min_loss"])],
            [float(want["final_loss"]), float(want["min_loss"])], **KTOL)
    assert (res.compile_count, res.shared_count, res.dispatch_count) == \
        (jres.compile_count, jres.shared_count, jres.dispatch_count)


def test_empty_sweep_raises():
    with pytest.raises(ValueError):
        fleet.run_fleet(points=[], packed=True, device="cpu")


def test_share_k_grid_pins_max_anchor():
    sweep = ("fed.k0=4,8,6",)
    pts = port_points(sweep)
    jpts = ref_points(sweep)
    assert all(p.spec.fed.k_grid0 == 8 and p.spec.fed.k_quantize
               for p in pts)
    assert [p.spec.as_dict() for p in pts] == \
        [p.spec.as_dict() for p in jpts]


def test_train_cli_sweep_smoke(capsys, tmp_path):
    from repro_torch.launch import train
    csv_path = str(tmp_path / "sweep.csv")
    result = train.main([
        "--rounds", "2", "--device", "cpu",
        *[a for ov in BASE for a in ("--set", ov)],
        "--set", "fed.k_schedule=fixed",
        "--sweep", "fed.k0=7,8", "--share-k-grid",
        "--sweep-csv", csv_path])
    out = capsys.readouterr().out
    assert "fleet:" in out and "k0=7" in out
    assert f"[train] fleet csv -> {csv_path}" in out
    with open(csv_path) as f:
        assert len(list(csv.DictReader(f))) == 2
    assert result.compile_count == 1 and result.shared_count == 1


def test_persistent_cache_is_unavailable(tmp_path):
    assert fleet.enable_persistent_cache(str(tmp_path)) is False


# ---------------------------------------------------------------------------
# fleet slices (tests/test_fleet.py::TestFleetSlices)
# ---------------------------------------------------------------------------

def test_local_fleet_slices_fresh_instances():
    be = LocalBackend("cpu")
    slices = be.fleet_slices(3)
    assert len(slices) == 3
    assert len({id(s) for s in slices}) == 3
    assert all(isinstance(s, LocalBackend) and s is not be
               and s.device == be.device and s.stream is None
               for s in slices)


class _RankMesh:
    """Duck-typed DeviceMesh over a rank grid (no process group)."""

    def __init__(self, ranks, names=("data", "model")):
        self.mesh = torch.as_tensor(np.asarray(ranks))
        self.mesh_dim_names = tuple(names)
        self.device_type = "cpu"

    def size(self, dim=None):
        return self.mesh.numel() if dim is None else self.mesh.shape[dim]


def test_mesh_fleet_slices_cycles_and_preserves_config(monkeypatch):
    """tests/test_fleet.py's check: a (2, 1) mesh carves into 2 slices,
    cycled over 4 points, each a MeshBackend with the parent's strategy,
    reduce, groups, acc_dtype and param_specs (sub-meshes carved from the
    rank grid, without a process group here)."""
    from repro_torch.core.engine.backends import mesh as mesh_mod
    monkeypatch.setattr(mesh_mod, "carve_submeshes", lambda m, n: [
        _RankMesh(g) for g in mesh_mod.carve_grid(m.mesh.numpy(), n)])
    specs = {"w": (None,)}
    be = MeshBackend(_RankMesh(np.arange(2).reshape(2, 1)),
                     reduce="grouped", acc_dtype=torch.bfloat16,
                     param_specs=specs)
    slices = be.fleet_slices(4)          # 2 sub-meshes cycled over 4
    assert len(slices) == 4
    assert [s.mesh.mesh.tolist() for s in slices] == [[[0]], [[1]]] * 2
    assert slices[0].mesh is slices[2].mesh
    assert all((s.strategy, s.reduce, s.acc_dtype, s.groups,
                s.param_specs, s.client_axes) == (
                    "parallel", "grouped", torch.bfloat16, 1, specs,
                    ("data",)) for s in slices)


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------

def test_launch_counters_exact_under_threads():
    """Each wrapper counts through ``_build.count_launch``: four threads
    bumping every counter at once lose no count."""
    counters = [(vars(fr), "launches"), (vars(fr), "sharded_launches"),
                (vars(fa), "launches"), (vars(mg), "launches"),
                (vars(ss), "launches"), (fa.launches_by_path, fa.PATHS[0]),
                (dc.launches, "int8_decompress_reduce"),
                (dc.sharded_launches, "int8_decode_apply_sharded")]
    before = [c[k] for c, k in counters]
    n, threads = 5000, 4
    gate = threading.Barrier(threads)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def bump():
        gate.wait()
        for _ in range(n):
            for c, k in counters:
                _build.count_launch(c, k)

    try:
        pool = [threading.Thread(target=bump) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
            assert not t.is_alive()
        assert [c[k] - b for (c, k), b in zip(counters, before)] == \
            [n * threads] * len(counters)
    finally:
        sys.setswitchinterval(switch)
        for (c, k), b in zip(counters, before):
            c[k] = b
