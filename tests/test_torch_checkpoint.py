"""Checkpoint and resume in the port: ``repro_torch.checkpoint`` against
the reference's key layout, bitwise resume of ``FedAvgTrainer`` (mirroring
``tests/test_data_checkpoint.py``), and runs saved by the reference's
``FederatedExperiment.save`` continued by the port's
``FederatedExperiment.restore``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro_torch.checkpoint import TensorSpec, load_checkpoint, save_checkpoint
from repro_torch.configs import FedConfig, get_paper_task
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.data import make_paper_task
from repro_torch.models import small
from repro_torch.optim import tree_leaves

from test_torch_parity_helpers import (assert_trees_close, drift_in_steps,
                                       flat, lm_spec, record_ids)
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

# tests/test_kernels.py's f32 tolerance
KTOL = dict(rtol=2e-4, atol=2e-4)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g),
            "b16": torch.randn(5, generator=g).to(torch.bfloat16),
            "t": torch.tensor(7, dtype=torch.int32),
            "q": {"q8_q": torch.randint(-127, 128, (6,), dtype=torch.int8,
                                        generator=g),
                  "q8_s": torch.tensor(0.25)},
            "slots": (torch.randn(2, 3, generator=g), ()),
            "none": None}


def _equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_round_trip_is_bitwise_and_atomic(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"old": torch.zeros(1)})
    save_checkpoint(path, tree, meta={"round": 3})      # replaces the old
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert sorted(data) == ["b16", "q/q8_q", "q/q8_s", "slots/0", "t",
                                "w"]
    like = {**tree, "b16": TensorSpec((5,), torch.bfloat16,
                                      torch.device("cpu"))}
    got, meta = load_checkpoint(path, like)
    assert meta == {"round": 3}
    assert got["none"] is None and got["slots"][1] == ()
    assert isinstance(got["slots"], tuple)
    for k in ("w", "b16", "t"):
        assert got[k].dtype == tree[k].dtype and torch.equal(got[k],
                                                             tree[k])
    assert torch.equal(got["q"]["q8_q"], tree["q"]["q8_q"])
    assert torch.equal(got["slots"][0], tree["slots"][0])
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]     # no tmp dir left


def test_shape_mismatch_and_missing_key_raise(tmp_path):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"a": {"w": torch.zeros(3, 4)}})
    with pytest.raises(ValueError, match="a/w"):
        load_checkpoint(path, {"a": {"w": torch.zeros(4, 3)}})
    with pytest.raises(KeyError):
        load_checkpoint(path, {"a": {"v": torch.zeros(3, 4)}})


def test_reference_arrays_load_into_the_port_and_back(tmp_path):
    """Both packages key leaves by the same ``/``-joined paths: a tree
    saved by ``repro.checkpoint.save_checkpoint`` loads into the port
    bitwise, and one saved by the port loads into the reference."""
    rng = np.random.default_rng(0)
    arrays = {"params": {"dense": {"kernel": rng.normal(size=(4, 3)),
                                   "bias": rng.normal(size=(3,))},
                         "embed": rng.normal(size=(5, 2))},
              "server": {"m": {"x": rng.normal(size=(2,))},
                         "t": np.int32(4)},
              "transport": (), "downlink": {"ref": rng.normal(size=(3,)),
                                            "res": ()}}
    arrays = jax.tree.map(lambda a: np.asarray(a, np.float32)
                          if np.asarray(a).dtype == np.float64 else a,
                          arrays)
    jtree = jax.tree.map(jnp.asarray, arrays)
    jpath = str(tmp_path / "ref")
    jsave(jpath, jtree, meta={"who": "reference"})
    like = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)).clone(),
                        arrays)
    like["transport"] = ()
    like["downlink"]["res"] = ()
    got, meta = load_checkpoint(jpath, like)
    assert meta == {"who": "reference"}
    _equal(got, jtree)
    tpath = str(tmp_path / "port")
    save_checkpoint(tpath, got)
    back, _ = jload(tpath, jtree)
    _equal(back, jtree)


# ---------------------------------------------------------------------------
# bitwise resume inside the port
# ---------------------------------------------------------------------------

def _femnist(clients=12, spc=16):
    """FEMNIST data and a narrow DNN (hidden 16) on the CPU."""
    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=clients, samples_per_client=spc)
    params = small.dnn_init(torch.Generator().manual_seed(0), 784, 62,
                            hidden=16)
    return task, data, params


def _mk(task, data, params, het=0.0, **fed_kw):
    kw = dict(total_clients=data.num_clients, clients_per_round=4,
              rounds=TOTAL, k0=4, eta0=0.3, batch_size=8,
              k_schedule="rounds", k_quantize=True, seed=0)
    kw.update(fed_kw)
    fed = FedConfig(**kw)
    rt = RuntimeModel(task.model_size_mb, task.runtime,
                      fed.clients_per_round, heterogeneity=het, seed=7)
    return FedAvgTrainer(lambda p, b: small.task_loss(p, task, b), params,
                         data, fed, rt, device="cpu")


def _split_run(tmp_path, mk, total, at):
    """(uninterrupted trainer, trainer saved at ``at`` and restored into a
    fresh one, resumed to ``total``, the history at the save)."""
    straight = mk()
    straight.run(total)
    first = mk()
    first.run(at)
    saved = first.history.as_dict()
    path = str(tmp_path / "mid")
    first.save_state(path)
    resumed = mk()
    resumed.restore_state(path)
    resumed.run(total, resume=True)
    return straight, resumed, saved


def _assert_bitwise(a, b):
    assert a.history.as_dict() == b.history.as_dict()
    for attr in ("params", "server_state"):
        _equal(getattr(a, attr), getattr(b, attr))
    for attr in ("transport_state", "downlink_state"):
        _equal(getattr(a.engine, attr), getattr(b.engine, attr))
    assert a.store.counters_meta() == b.store.counters_meta()


# rounds of the resume tests, and the round of the save
TOTAL, AT = 6, 4

RESUME_CASES = {
    # name: (fed kwargs, heterogeneity)
    "plain": (dict(), 0.0),
    "int8": (dict(transport="int8"), 0.0),
    "topk": (dict(transport="topk", topk_frac=0.2), 0.0),
    "fedadam": (dict(server_optimizer="fedadam", server_lr=0.05), 0.0),
    "error-schedule": (dict(k_schedule="error", eta_schedule="error",
                            k_quantize=False, loss_window=3), 0.0),
    "straggler-rng": (dict(transport="int8", k_schedule="fixed"), 0.5),
    "int8-up-q8-down": (dict(transport="int8", downlink="int8",
                             downlink_ref="q8"), 0.0),
    "fixed-cohort-topk": (dict(transport="topk", topk_frac=0.25,
                               sampler="fixed_cohort",
                               cohort=(0, 3, 5, 9)), 0.0),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_mid_schedule_resume_is_bitwise(tmp_path, case):
    """save_state after AT rounds + restore_state + run(TOTAL,
    resume=True) equals the uninterrupted TOTAL rounds bit for bit: params, server state,
    codec state (per-client residual slots with their leading axis),
    history, counters. The error schedule's controller state, the
    straggler stream and the sample stream carry over."""
    fed_kw, het = RESUME_CASES[case]
    task, data, params = _femnist()
    mk = lambda: _mk(task, data, params, het=het, **fed_kw)
    straight, resumed, saved = _split_run(tmp_path, mk, TOTAL, AT)
    _assert_bitwise(straight, resumed)
    assert resumed.store.version == TOTAL
    if het:
        # the straggler stream moves the clock off the homogeneous Eq. 5
        homog = _mk(task, data, params, **fed_kw)
        homog.run(TOTAL)
        assert homog.history.wall_clock_s != resumed.history.wall_clock_s
    if case == "fixed-cohort-topk":
        slots = tree_leaves(resumed.engine.transport_state)
        assert resumed.engine.transport.ef_slots == 4
        assert all(t.shape[0] == 4 for t in slots)
    if case == "error-schedule":
        assert resumed.ctrl.state_dict() == straight.ctrl.state_dict()
    # resume past the end runs nothing
    before = [t.clone() for t in tree_leaves(resumed.params)]
    resumed.run(TOTAL, resume=True)
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(resumed.params)))
    assert resumed.history.rounds == list(range(1, TOTAL + 1))
    assert saved["rounds"] == list(range(1, AT + 1))


def test_resume_continues_wire_byte_counters(tmp_path):
    """The first round after the seam charges the wire on top of the
    restored totals: no reset, no second charge of the rounds already paid
    for."""
    task, data, params = _femnist()
    mk = lambda: _mk(task, data, params, transport="int8", downlink="int8")
    straight, resumed, saved = _split_run(tmp_path, mk, TOTAL, AT)
    h = resumed.history
    assert saved["uplink_mbit"][-1] > 0 and saved["downlink_mbit"][-1] > 0
    assert h.uplink_mbit[:AT] == saved["uplink_mbit"]
    assert h.uplink_mbit[AT] > saved["uplink_mbit"][-1]
    assert h.downlink_mbit[AT] > saved["downlink_mbit"][-1]
    _assert_bitwise(straight, resumed)


def test_restore_backfills_downlink_mbit_and_drops_unknown_fields(tmp_path):
    """A checkpoint from before downlink accounting (no ``down_mbit``,
    no ``history.downlink_mbit``) restores with a zero-filled series;
    history fields this schema lacks are dropped with a warning."""
    task, data, params = _femnist(8, 20)
    mk = lambda: _mk(task, data, params, rounds=6, k0=2, batch_size=4,
                     k_schedule="fixed", k_quantize=False, loss_window=3)
    first = mk()
    first.run(4)
    path = str(tmp_path / "old")
    first.save_state(path)
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["down_mbit"], meta["history"]["downlink_mbit"]
    del meta["store_version"]
    meta["history"]["bogus"] = [1]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    resumed = mk()
    with pytest.warns(UserWarning, match="bogus"):
        resumed.restore_state(path)
    h = resumed.history
    assert h.downlink_mbit == [0.0] * 4
    assert resumed.store.version == 4        # the round count stands in
    resumed.run(6, resume=True)
    assert len(h.downlink_mbit) == len(h.rounds) == 6
    assert h.downlink_mbit[4] > 0.0           # new rounds charge on top


def test_f32_ref_checkpoint_restores_into_a_q8_store(tmp_path):
    """The legacy-key fallback: a run with an f32 broadcast reference
    restores into a trainer whose store wants q8; the reference and
    residual are re-bracketed through ``store_tree``."""
    task, data, params = _femnist()
    mk = lambda ref: _mk(task, data, params, transport="int8",
                         downlink="int8", downlink_ref=ref)
    first = mk("f32")
    first.run(3)
    path = str(tmp_path / "f32")
    first.save_state(path)
    q8 = mk("q8")
    q8.restore_state(path)
    dl = q8.engine.downlink
    want = dl.store_tree(first.engine.downlink_state["ref"])
    _equal(q8.engine.downlink_state["ref"], want)
    _equal(q8.engine.downlink_state["res"],
           dl.store_tree(first.engine.downlink_state["res"]))
    _equal(q8.params, first.params)
    q8.run(4, resume=True)
    assert q8.history.rounds == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# across frameworks: the reference saves, the port continues
# ---------------------------------------------------------------------------

FEMNIST_SPEC = (
    "data.kind=paper", "data.task=femnist", "data.clients=16",
    "data.samples_per_client=16", "fed.clients_per_round=4", "fed.k0=4",
    "fed.eta0=0.05", "fed.batch_size=8", "fed.k_schedule=rounds",
    "transport.name=none", "fed.server_optimizer=fedavgm",
    "fed.server_lr=0.5", "runtime.heterogeneity=0.5")
CROSS = ["local-int8-decayK", "local-int8-downlink", "adaptive-downlink",
         "fixed-cohort-topk", "femnist-fedavgm-straggler"]
# the LM specs at a smaller step (the traffic's shape kept): time
LM_SMALL = ("data.seq_len=16", "fed.batch_size=2", "fed.k0=3")
COUNTERS = ("rounds", "k", "eta", "sgd_steps", "wall_clock_s",
            "uplink_mbit", "downlink_mbit")


def _reference_spec(name):
    if name == "femnist-fedavgm-straggler":
        return lm_spec("local-int8-decayK", *FEMNIST_SPEC)
    return lm_spec(name, *LM_SMALL)


@pytest.mark.parametrize("name", CROSS)
def test_reference_checkpoint_continues_in_the_port(tmp_path, name):
    """The reference ``build``s the spec (the LM specs at seq 16, b 2, k0 3:
    K 3, 3, 3, 2, 2, 2, so the resume crosses a change of K)
    and ``FederatedExperiment.save``s at round 0 and round 3, then continues to round 6. The port's
    ``FederatedExperiment.restore`` of each checkpoint holds the saved
    state bit for bit and continues to round 6 too: counters and client
    ids exact, losses allclose. Params: allclose without a codec; within
    one int8 step of each leaf's movement since the checkpoint for int8
    (the rule of the whole-run LM tests); for top-k, whose selections
    flip at ties across the packages (ROADMAP C5), within 0.05 steps in
    each leaf's mean."""
    from repro.api.experiment import build as jbuild
    from repro_torch.api import FederatedExperiment
    jexp = jbuild(_reference_spec(name))
    jids = record_ids(jexp.trainer)
    r0, r3 = str(tmp_path / "r0"), str(tmp_path / "r3")
    jexp.save(r0)
    jexp.run(3)
    jexp.save(r3)
    at3 = jax.tree.map(np.asarray, jexp.params)
    jexp.trainer.run(6, resume=True)
    jh = jexp.history
    want = jax.tree.map(np.asarray, jexp.trainer.params)
    spec = _reference_spec(name)
    for path, start in ((r3, at3), (r0, None)):
        exp = FederatedExperiment.restore(path, device="cpu")
        assert exp.trainer.device == torch.device("cpu")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            state = flat(exp.trainer.store.checkpoint_tree())
            held = {k.rstrip("/"): v for k, v in state.items()
                    if v.size or k.rstrip("/") in data}
            assert sorted(held) == sorted(data)
            for k in data:
                np.testing.assert_array_equal(held[k], data[k], err_msg=k)
        ids = record_ids(exp.trainer)
        h = exp.trainer.run(6, resume=True)
        first = 3 if path == r3 else 0
        assert ids == jids[first:]
        for key in COUNTERS:
            assert getattr(h, key) == getattr(jh, key), key
        np.testing.assert_allclose(h.train_loss, jh.train_loss, **KTOL)
        assert exp.trainer.store.version == 6
        if start is None:
            with np.load(os.path.join(r0, "arrays.npz")) as data:
                start = {k[len("params/"):]: data[k] for k in data
                         if k.startswith("params/")}
            start = _unflat(start)
        if spec.transport.name == "none":
            assert_trees_close(exp.params, want, **KTOL)
            continue
        worst, mean = drift_in_steps(exp.params, want, start)
        assert mean <= 0.05, (path, worst, mean)
        if spec.transport.name == "int8":
            assert worst <= 1.0, (path, worst, mean)


def _unflat(flat_arrays):
    tree = {}
    for k, v in flat_arrays.items():
        node = tree
        *heads, last = k.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree
