"""Rank bodies of the multi-rank runs in tests/test_torch_mesh.py and
tests/test_torch_sequential.py (no tests of its own).

``spawn`` starts ``world`` gloo ranks on the CPU with
``torch.multiprocessing`` (``init_method="file://..."`` in the test's own
temporary directory, so parallel test workers never share a port). The
ranks import this module and not the test file, so they import no JAX.
Each rank returns what it computed; ``spawn`` hands the parent every
rank's result, to hold against single-process runs.
"""
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import FedConfig, get_paper_task
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.core.engine.backends import MeshBackend
from repro_torch.core.engine.round import RoundEngine
from repro_torch.core.engine.transport import Int8Transport
from repro_torch.data import make_paper_task, pipeline
from repro_torch.kernels import collectives, ref
from repro_torch.kernels import delta_codec as dc
from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import small

# the meshes of the multi-rank runs: world size -> (shape, axis names)
MESHES = {2: ((2, 1), ("data", "model")), 4: ((2, 2), ("pod", "data"))}
# uneven client rows: 25 = 13 + 12 = 7 + 6 + 6 + 6 (CIFAR100's U)
N_ROWS, M_COLS, M_ODD, K_TOPK = 25, 1000, 999, 16
# the trainer runs: narrow FEMNIST, 5 clients a round (3 + 2, 2 + 1 + 1 + 1)
TRAINER_RUNS = {
    "mean": dict(aggregator="mean"),
    "kernel": dict(aggregator="kernel"),
    "trimmed_mean+fedavgm": dict(aggregator="trimmed_mean",
                                 server_optimizer="fedavgm", server_lr=0.5),
    "median+fedyogi": dict(aggregator="median", server_optimizer="fedyogi",
                           server_lr=0.1),
}
TRAINER_ROUNDS = 3
WIRE_PAIRS = [("int8", "int8x2"), ("int8x2", "int8"), ("topk", "topk")]
# the sequential strategy's runs: narrow FEMNIST, 4 clients a round in 2
# groups (one a pod on the (2, 2) pod x data mesh), b = 4 split over
# "data" (2 rows a rank)
SEQ_GROUPS = 2
SEQ_RUNS = {
    "mean": dict(aggregator="mean"),
    "trimmed_mean+fedavgm": dict(aggregator="trimmed_mean",
                                 server_optimizer="fedavgm", server_lr=0.5),
    "int8": dict(aggregator="mean", transport="int8"),
    "topk+cohort": dict(transport="topk", sampler="fixed_cohort",
                        cohort=(0, 2, 5, 7)),
}
# per-client error feedback on the parallel strategy: 5 rows a round
PARALLEL_EF_RUN = dict(transport="topk", sampler="fixed_cohort",
                       cohort=(0, 2, 3, 5, 7))


def spawn(fn, world: int, tmp_path, *args):
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns the
    ranks' results in rank order."""
    out = str(tmp_path)
    mp.spawn(_entry, args=(fn, world, out, args), nprocs=world, join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, fn, world, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/pg",
                            rank=rank, world_size=world)
    try:
        res = fn(rank, world, *args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def kernel_inputs(seed: int = 0) -> dict:
    """The same numpy inputs on every rank and in the parent: client rows
    of every sharded kernel, duplicate top-k indices and -1 padding
    included."""
    rng = np.random.default_rng(seed)
    n, m = N_ROWS, M_COLS
    w = rng.random(n).astype(np.float32)
    idx = rng.integers(0, m, (n, K_TOPK)).astype(np.int32)
    idx[::5, -1] = -1
    return {
        "x": rng.normal(size=(n, m)).astype(np.float32),
        "w": w / w.sum(),
        "q": rng.integers(-127, 128, (n, m)).astype(np.int8),
        "qr": rng.integers(-127, 128, (n, m)).astype(np.int8),
        "w_eff": (rng.random(n) / 127).astype(np.float32),
        "wr_eff": (rng.random(n) / 127 ** 2).astype(np.float32),
        "vals": rng.normal(size=(n, K_TOPK)).astype(np.float32),
        "idx": idx,
        "ref": rng.normal(size=m).astype(np.float32),
        "s": np.array([0.013], np.float32),
        "rs": np.array([0.0001], np.float32),
        "ref_odd": rng.normal(size=M_ODD).astype(np.float32),
        "q_odd": rng.integers(-127, 128, M_ODD).astype(np.int8),
    }


def sharded_outputs(mesh, axes, tiers, plain: bool = False) -> dict:
    """Every sharded function on this rank's rows (``plain``: the plain
    sharded versions of ``kernels.ref``) of ``kernel_inputs()``."""
    t = {k: torch.tensor(v) for k, v in kernel_inputs().items()}
    lo, hi = collectives.rows_of(mesh, axes, N_ROWS)
    kw = dict(mesh=mesh, client_axes=axes, reduce_tiers=tiers)
    fns = (dict(fedavg=ref.fedavg_reduce_sharded_ref,
                int8=ref.int8_decompress_reduce_sharded_ref,
                apply=ref.int8_decode_apply_sharded_ref,
                topk=ref.topk_scatter_reduce_sharded_ref) if plain else
           dict(fedavg=fr.fedavg_reduce_sharded,
                int8=dc.int8_decompress_reduce_sharded,
                apply=dc.int8_decode_apply_sharded,
                topk=dc.topk_scatter_reduce_sharded))
    rows = lambda name: t[name][lo:hi]
    return {
        "fedavg": fns["fedavg"](rows("x"), rows("w"), **kw),
        "fedavg.bf16": fns["fedavg"](rows("x").to(torch.bfloat16),
                                     rows("w"), **kw),
        "int8": fns["int8"](rows("q"), rows("w_eff"), **kw),
        "int8x2": fns["int8"](rows("q"), rows("w_eff"), rows("qr"),
                              rows("wr_eff"), **kw),
        "topk": fns["topk"](rows("vals"), rows("idx"), rows("w"), M_COLS,
                            **kw),
        "apply": fns["apply"](t["ref"], t["q"][0], t["s"], mesh=mesh,
                              axes=axes),
        "apply2": fns["apply"](t["ref"], t["q"][0], t["s"], t["qr"][0],
                               t["rs"], mesh=mesh, axes=axes),
    }


def unsharded_outputs() -> dict:
    """The same functions, unsharded, in plain PyTorch."""
    t = {k: torch.tensor(v) for k, v in kernel_inputs().items()}
    return {
        "fedavg": ref.fedavg_reduce_ref(t["x"], t["w"]),
        "fedavg.bf16": ref.fedavg_reduce_ref(t["x"].to(torch.bfloat16),
                                             t["w"]),
        "int8": ref.int8_decompress_reduce_ref(t["q"], t["w_eff"]),
        "int8x2": ref.int8_decompress_reduce_ref(t["q"], t["w_eff"],
                                                 t["qr"], t["wr_eff"]),
        "topk": ref.topk_scatter_reduce_ref(t["vals"], t["idx"], t["w"],
                                            M_COLS),
        "apply": ref.int8_decode_apply_ref(t["ref"], t["q"][0], t["s"]),
        "apply2": ref.int8_decode_apply_ref(t["ref"], t["q"][0], t["s"],
                                            t["qr"][0], t["rs"]),
    }


def femnist_setup():
    """Narrow FEMNIST (the DNN at hidden 16), 8 clients of 10 samples."""
    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=8, samples_per_client=10)
    params = small.dnn_init(torch.Generator().manual_seed(0), 784, 62,
                            hidden=16)
    return task, data, params, lambda p, b: small.task_loss(p, task, b)


def run_trainer(backend, rounds=TRAINER_ROUNDS, **fed_kw):
    """``FedAvgTrainer`` on narrow FEMNIST, 5 clients a round, on the CPU;
    returns (params, History)."""
    task, data, params, loss_fn = femnist_setup()
    fed = FedConfig(total_clients=8, clients_per_round=5, rounds=rounds,
                    k0=3, eta0=0.3, batch_size=4, k_schedule="rounds",
                    seed=0, **fed_kw)
    tr = FedAvgTrainer(loss_fn, params, data, fed,
                       RuntimeModel(task.model_size_mb, task.runtime, 5),
                       device="cpu", backend=backend)
    h = tr.run(rounds)
    return tr.params, h


def run_seq_trainer(backend, rounds=TRAINER_ROUNDS, **fed_kw):
    """``run_trainer`` at the sequential runs' traffic: 4 clients a round,
    b = 4; returns (params, History, the codec state)."""
    task, data, params, loss_fn = femnist_setup()
    fed = FedConfig(total_clients=8, clients_per_round=4, rounds=rounds,
                    k0=3, eta0=0.3, batch_size=4, k_schedule="rounds",
                    seed=0, **fed_kw)
    tr = FedAvgTrainer(loss_fn, params, data, fed,
                       RuntimeModel(task.model_size_mb, task.runtime, 4),
                       device="cpu", backend=backend)
    h = tr.run(rounds)
    return tr.params, h, tr.engine.transport_state


def seq_refusals(mesh) -> dict:
    """The sequential strategy's refusals on this world, by message."""
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    tries = {
        "pod": lambda: MeshBackend(mesh, strategy="sequential", groups=1),
        "param_specs": lambda: MeshBackend(mesh, strategy="sequential",
                                           param_specs={}),
        "model": lambda: MeshBackend(
            init_device_mesh("cpu", (1, dist.get_world_size()),
                             mesh_dim_names=("data", "model")),
            strategy="sequential"),
        "groups": lambda: MeshBackend(
            mesh, strategy="sequential", groups=3).rows(4),
    }
    for name, fn in tries.items():
        try:
            fn()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def seq_rank_body(rank, world):
    """The sequential strategy on ``MESHES[world]``: every run of
    ``SEQ_RUNS`` under flat and grouped reduce, per-client error feedback
    on the parallel strategy, and the refusals."""
    shape, names = MESHES[world]
    mesh = make_mesh(shape, names, "cpu")
    res = {"rank": rank}
    for reduce in ("flat", "grouped"):
        for name, kw in SEQ_RUNS.items():
            backend = MeshBackend(mesh, strategy="sequential",
                                  groups=SEQ_GROUPS, reduce=reduce)
            res[f"seq.{reduce}.{name}"] = run_seq_trainer(backend, **kw)
            res[f"split.{reduce}.{name}"] = backend._b_split
    res["parallel_ef"] = run_trainer_state(MeshBackend(mesh),
                                           **PARALLEL_EF_RUN)
    res["refusals"] = seq_refusals(mesh)
    res["counts"] = dict(collectives.counts)
    return res


def run_trainer_state(backend, **fed_kw):
    """``run_trainer``, with the codec state: (params, History, state)."""
    task, data, params, loss_fn = femnist_setup()
    fed = FedConfig(total_clients=8, clients_per_round=5,
                    rounds=TRAINER_ROUNDS, k0=3, eta0=0.3, batch_size=4,
                    k_schedule="rounds", seed=0, **fed_kw)
    tr = FedAvgTrainer(loss_fn, params, data, fed,
                       RuntimeModel(task.model_size_mb, task.runtime, 5),
                       device="cpu", backend=backend)
    h = tr.run(TRAINER_ROUNDS)
    return tr.params, h, tr.engine.transport_state


def wire_rounds(backend, up: str, down: str, rounds: int = 3):
    """The codec pair round by round: each round of the local engine and of
    ``backend``'s engine starts from the local engine's state before it.
    Returns [(params before, local params, backend's params)] a round."""
    _, data, params, loss_fn = femnist_setup()
    kw = dict(aggregator="kernel", transport=up, downlink=down)
    local = RoundEngine(loss_fn, device="cpu", **kw)
    mesh = RoundEngine(loss_fn, backend=backend, **kw)
    local.init_transport_state(params)
    local.init_downlink_state(params)
    rng = np.random.default_rng(3)
    out = []
    for _ in range(rounds):
        bb = pipeline.bucket_batches(rng, data, n_rounds=1, k=3,
                                     clients_per_round=5, batch_size=4)
        scalars = (np.full(1, 0.3, np.float32), np.ones(1, bool), ())
        mesh.transport_state = local.transport_state
        mesh.downlink_state = local.downlink_state
        got = mesh.run_bucket(params, bb.batches, bb.weights, *scalars)[0]
        want = local.run_bucket(params, bb.batches, bb.weights,
                                *scalars)[0]
        out.append((params, want, got))
        params = want
    return out


def rank_body(rank, world, trainers: bool, wire: bool):
    """Everything one spawn checks on its mesh (``MESHES[world]``): the
    sharded kernels flat and grouped, kernel and plain; the trainer runs,
    flat and grouped; the codec pairs round by round (flat)."""
    shape, names = MESHES[world]
    mesh = make_mesh(shape, names, "cpu")
    axes = ("pod", "data") if "pod" in names else ("data",)
    grouped = tuple((a,) for a in reversed(axes))
    res = {"rank": rank, "rows": collectives.rows_of(mesh, axes, N_ROWS)}
    for tname, tiers in (("flat", None), ("grouped", grouped)):
        res[f"kernels.{tname}"] = sharded_outputs(mesh, axes, tiers)
        res[f"plain.{tname}"] = sharded_outputs(mesh, axes, tiers,
                                                plain=True)
    # the bound int8 codec on a leaf the ranks do not divide (M = 999):
    # every rank reconstructs the whole leaf
    codec = Int8Transport(levels=1)
    t = {k: torch.tensor(v) for k, v in kernel_inputs().items()}
    payload, leaf = [{"q": t["q_odd"], "s": t["s"]}], {"w": t["ref_odd"]}
    res["apply_odd"] = (
        codec.with_mesh(mesh, axes).decode_apply(payload, leaf)["w"],
        codec.decode_apply(payload, leaf)["w"])
    try:                               # the sharded kernel itself refuses it
        dc.int8_decode_apply_sharded(t["ref_odd"], t["q_odd"], t["s"],
                                     mesh=mesh, axes=axes)
        res["apply_odd_refused"] = ""
    except ValueError as e:
        res["apply_odd_refused"] = str(e)
    if trainers:
        for reduce in ("flat", "grouped"):
            for name, kw in TRAINER_RUNS.items():
                res[f"trainer.{reduce}.{name}"] = run_trainer(
                    MeshBackend(mesh, reduce=reduce), **kw)
    if wire:
        for up, down in WIRE_PAIRS:
            res[f"wire.{up}/{down}"] = wire_rounds(MeshBackend(mesh), up,
                                                   down)
    res["counts"] = dict(collectives.counts)
    return res

