"""Rank bodies of the multi-rank runs in tests/test_torch_mesh.py,
tests/test_torch_sequential.py, tests/test_torch_sharding.py,
tests/test_torch_mesh_paths.py, tests/test_torch_tensor_parallel.py,
tests/test_torch_tp_decode.py and tests/test_torch_tp_encdec.py (and the
card's in tests/test_torch_cuda.py), and the
JAX-free MoE routing helpers those files share with tests/test_torch_cuda.py
(no tests of its own).

``spawn`` starts ``world`` gloo ranks on the CPU with
``torch.multiprocessing`` (``init_method="file://..."`` in the test's own
temporary directory, so parallel test workers never share a port). The
ranks import this module and not the test file, so they import no JAX.
Each rank returns what it computed; ``spawn`` hands the parent every
rank's result, to hold against single-process runs.
"""
import contextlib
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
from repro_torch.distributed import (make_prefill_step, make_serve_step,
                                     sharding)
from repro_torch.kernels import collectives, ref
from repro_torch.kernels import delta_codec as dc
from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, registry, small

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


@contextlib.contextmanager
def routing_ids():
    """The routing ids (tokens, top k) of every ``models.moe._route`` call
    inside the block, one MoE layer a call, in call order."""
    route, calls = moe._route, []

    def recording(p, cfg, xf):
        out = route(p, cfg, xf)
        calls.append(out[1])
        return out

    moe._route = recording
    try:
        yield calls
    finally:
        moe._route = route


def dropped(ids, groups: int, cap: int, num_experts: int) -> int:
    """The assignments a dispatch drops over capacity, from one call's
    routing ids: each of ``groups`` equal runs of rows (the token groups
    of ``dispatch_sharded``, group-major; 1 for ``dispatch``) keeps at
    most ``cap`` assignments an expert."""
    g = ids.reshape(groups, -1)
    counts = torch.sum(g[..., None] == torch.arange(
        num_experts, device=ids.device), dim=1)
    return int(torch.clamp(counts - cap, min=0).sum())


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
        # params sharded over "pod", whose ranks run different groups
        "param_specs": lambda: MeshBackend(
            mesh, strategy="sequential", groups=2,
            param_specs={"w": (("data", "pod"),)}),
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



# ---------------------------------------------------------------------------
# sharded parameters (MeshBackend(param_specs=...)), run by
# tests/test_torch_sharding.py
# ---------------------------------------------------------------------------

# name -> (world, mesh shape, axis names, strategy, param_pspecs keywords)
SHARD_MESHES = {
    "seq2d": (2, (2, 1), ("data", "model"), "sequential",
              dict(two_d=True)),
    "par1d": (4, (2, 2), ("data", "model"), "parallel", dict()),
    "fsdp_pod": (4, (2, 2), ("pod", "data"), "parallel",
                 dict(two_d=True, fsdp_axes=("data", "pod"))),
}
# FEMNIST runs at run_seq_trainer's traffic (4 a round, b 4, 3 rounds)
SHARD_RUNS = {
    "mean": dict(aggregator="mean"),
    "trimmed_mean+fedavgm": dict(aggregator="trimmed_mean",
                                 server_optimizer="fedavgm", server_lr=0.5),
    "int8/int8": dict(transport="int8", downlink="int8"),
    "topk": dict(transport="topk"),
    "topk+slots/int8-q8": dict(transport="topk", sampler="fixed_cohort",
                               cohort=(0, 2, 5, 7), downlink="int8",
                               downlink_ref="q8"),
    "int8x2/adaptive+fedyogi": dict(transport="int8x2", downlink="adaptive",
                                    server_optimizer="fedyogi",
                                    server_lr=0.1),
}
# the checkpointed run: saved after CKPT_AT rounds of the 2-rank run
CKPT_RUN = dict(transport="int8", downlink="int8", downlink_ref="q8",
                server_optimizer="fedavgm", server_lr=0.5)
CKPT_AT = 2


def shard_specs(mesh, params, kw):
    from repro_torch.distributed import sharding
    return sharding.param_pspecs(None, params, sharding.MeshShape.of(mesh),
                                 **kw)


def placed_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in
               (x for x in _leaves(tree) if isinstance(x, torch.Tensor)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def shard_femnist(backend, rounds=TRAINER_ROUNDS, **fed_kw):
    """``run_seq_trainer``'s run; returns its results and what the store
    holds at rest (this rank's bytes of params and server state)."""
    task, data, params, loss_fn = femnist_setup()
    fed = FedConfig(total_clients=8, clients_per_round=4, rounds=rounds,
                    k0=3, eta0=0.3, batch_size=4, k_schedule="rounds",
                    seed=0, **fed_kw)
    tr = FedAvgTrainer(loss_fn, params, data, fed,
                       RuntimeModel(task.model_size_mb, task.runtime, 4),
                       device="cpu", backend=backend)
    h = tr.run(rounds)
    return {"params": tr.params, "history": h,
            "t_state": tr.store.gather(tr.engine.transport_state),
            "d_state": tr.store.gather(tr.engine.downlink_state),
            "server": tr.store.gather(tr.server_state),
            "counts": (tr.compile_count, tr.shared_count,
                       tr.dispatch_count),
            "params_bytes": placed_bytes(tr.store.params),
            "server_bytes": placed_bytes(tr.store.server_state)}, tr


def shard_lm(backend, rounds=2):
    """``mesh-sequential-cosine.json`` at reduced width (seq 16, b 2),
    int8 both ways, through ``api.build``."""
    from pathlib import Path
    from repro_torch.api.experiment import build
    from repro_torch.api.spec import ExperimentSpec
    path = (Path(__file__).resolve().parents[1] / "examples" / "specs"
            / "mesh-sequential-cosine.json")
    spec = ExperimentSpec.load(str(path)).with_overrides(
        f"fed.rounds={rounds}", "data.seq_len=16", "fed.batch_size=2",
        "transport.name=int8", "transport.downlink=int8")
    exp = build(spec, backend=backend)
    h = exp.run(rounds)
    tr = exp.trainer
    return {"params": tr.params, "history": h,
            "counts": (tr.compile_count, tr.shared_count,
                       tr.dispatch_count),
            "params_bytes": placed_bytes(tr.store.params)}


def layout_check(mesh) -> dict:
    """``block_of`` and ``gather_leaf`` against a hand-built layout: a
    (8, 6) leaf split over ("data", "pod") on dim 0 (data major) and over
    "model" (where the mesh has it) on dim 1."""
    names = tuple(mesh.mesh_dim_names)
    x = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    if "pod" in names:
        spec = (("data", "pod"), None)
        d = collectives.client_rank(mesh, ("data",))
        p = collectives.client_rank(mesh, ("pod",))
        want = x[(d * 2 + p) * 2:(d * 2 + p + 1) * 2]
    else:
        spec = ("data", "model")
        d = collectives.client_rank(mesh, ("data",))
        m = collectives.client_rank(mesh, ("model",))
        nm = collectives.axes_size(mesh, ("model",))
        w = 6 // nm
        want = x[d * 4:(d + 1) * 4, m * w:(m + 1) * w]
    block = collectives.block_of(x, spec, mesh)
    return {"block": block, "want": want,
            "gathered": collectives.gather_leaf(block, spec, mesh),
            "x": x}


def shard_rank_body(rank, world, name, tmp):
    """Every run of ``SHARD_RUNS`` on the mesh ``SHARD_MESHES[name]``
    without and with ``param_specs``; the sequential mesh adds the LM run
    and the checkpoint (saved by every rank, rank 0's kept)."""
    _, shape, names, strategy, rule = SHARD_MESHES[name]
    mesh = make_mesh(shape, names, "cpu")
    _, _, params, _ = femnist_setup()
    specs = shard_specs(mesh, params, rule)
    groups = 2 if strategy == "sequential" else 1
    res = {"rank": rank, "layout": layout_check(mesh), "specs": specs}
    for run, kw in SHARD_RUNS.items():
        for tag, sp in (("plain", None), ("sharded", specs)):
            backend = MeshBackend(mesh, strategy=strategy, groups=groups,
                                  param_specs=sp)
            res[f"{tag}.{run}"] = shard_femnist(backend, **kw)[0]
    if strategy == "sequential":
        from repro_torch.configs import get_arch
        from repro_torch.models import registry
        cfg = get_arch("qwen1.5-0.5b-reduced")
        lm_specs = shard_specs(mesh, registry.shapes(cfg), rule)
        res["lm_specs"] = lm_specs
        for tag, sp in (("plain", None), ("sharded", lm_specs)):
            res[f"{tag}.lm"] = shard_lm(MeshBackend(
                mesh, strategy="sequential", groups=1, param_specs=sp))
        for tag, sp in (("plain", None), ("sharded", specs)):
            _, tr = shard_femnist(MeshBackend(
                mesh, strategy=strategy, groups=groups, param_specs=sp),
                rounds=CKPT_AT, **CKPT_RUN)
            path = os.path.join(tmp, f"ckpt.{tag}.rank{rank}")
            tr.save_state(path)
            res[f"ckpt.{tag}"] = path
    return res


# ---------------------------------------------------------------------------
# streaming cohorts, the async engine and fleet sub-meshes on a mesh, run by
# tests/test_torch_mesh_paths.py
# ---------------------------------------------------------------------------

# streamed rounds: narrow FEMNIST, 5 clients a round in slabs of
# SLAB_C[world]: on 2 ranks slabs of 2, 2 and 1 (rows 1 + 1, 1 + 0: the
# tail below the world), on 4 ranks slabs of 3 and 2 (1 + 1 + 1 + 0,
# 1 + 1 + 0 + 0)
SLAB_C = {2: 2, 4: 3}
SLAB_ROUNDS = 2
SLAB_RUNS = {
    "mean": dict(aggregator="mean"),
    "kernel": dict(aggregator="kernel"),
    "int8": dict(transport="int8"),
    "topk+slots": dict(transport="topk", sampler="fixed_cohort",
                       cohort=(0, 2, 3, 5, 7)),
}
# FSDP (param_specs over "data", 2 ranks) against the replicated twin
SLAB_SHARDED = {
    "int8+fedavgm": dict(transport="int8", server_optimizer="fedavgm",
                         server_lr=0.5),
    "topk+slots": SLAB_RUNS["topk+slots"],
}
FSDP_RULE = dict(two_d=True)
# the async engine: 4 in flight, a buffer of 2, staleness-weighted, int8
# with per-slot residuals, heterogeneity 0.7. The checkpointed run: a
# buffer of 3 at heterogeneity 0 (each group of 4 arrivals applies 3 and
# leaves 1 or 2 folded), saved after ASYNC_SAVE_AT applications
ASYNC_RUN = dict(aggregation="async", buffer_size=2, staleness_weight="inv",
                 max_staleness=4, transport="int8", k_schedule="rounds")
ASYNC_APPLIES, ASYNC_SAVE_AT, ASYNC_HET = 5, 2, 0.7
ASYNC_CKPT = dict(buffer_size=3)
# the packed fleet: 4 FEMNIST points on the 4-rank (2, 2) pod x data
# mesh's 2 slices of (1, 2)
FLEET_BASE = ("data.kind=paper", "data.task=femnist", "data.clients=8",
              "data.samples_per_client=10", "fed.clients_per_round=4",
              "fed.rounds=3", "fed.batch_size=4", "fed.eval_every=0",
              "backend.name=mesh")
FLEET_SWEEP = ("fed.k0=2,3", "transport.name=none,int8")


@contextlib.contextmanager
def kernel_rows():
    """The client rows of every call of the single-device kernels the
    sharded wrappers run on a rank's rows (``fedavg_reduce``,
    ``int8_decompress_reduce``, ``topk_scatter_reduce``), by kernel, in
    call order: a call with no row would be a launch with none."""
    seen = {"fedavg_reduce": [], "int8_decompress_reduce": [],
            "topk_scatter_reduce": []}
    mods = {"fedavg_reduce": fr, "int8_decompress_reduce": dc,
            "topk_scatter_reduce": dc}
    saved = {name: getattr(mod, name) for name, mod in mods.items()}

    def counting(name):
        fn = saved[name]

        def call(x, *a, **kw):
            seen[name].append(int(x.shape[0]))
            return fn(x, *a, **kw)
        return call

    for name, mod in mods.items():
        setattr(mod, name, counting(name))
    try:
        yield seen
    finally:
        for name, mod in mods.items():
            setattr(mod, name, saved[name])


def run_slabs(backend, chunk, rounds=SLAB_ROUNDS, **fed_kw):
    """``FedAvgTrainer`` on narrow FEMNIST, 5 clients a round in slabs of
    ``chunk``; returns its params, History, codec and server state (whole
    leaves) and counts."""
    task, data, params, loss_fn = femnist_setup()
    fed = FedConfig(total_clients=8, clients_per_round=5, rounds=rounds,
                    k0=3, eta0=0.3, batch_size=4, k_schedule="rounds",
                    seed=0, cohort_chunk=chunk, **fed_kw)
    tr = FedAvgTrainer(loss_fn, params, data, fed,
                       RuntimeModel(task.model_size_mb, task.runtime, 5),
                       device="cpu", backend=backend)
    h = tr.run(rounds)
    return {"params": tr.params, "history": h,
            "t_state": tr.store.gather(tr.engine.transport_state),
            "server": tr.store.gather(tr.server_state),
            "counts": (tr.compile_count, tr.shared_count,
                       tr.dispatch_count),
            "params_bytes": placed_bytes(tr.store.params)}


def async_engine(backend, het=ASYNC_HET, rounds=ASYNC_APPLIES, **fed_kw):
    """The async engine on narrow FEMNIST (``ASYNC_RUN``)."""
    from repro_torch.core.engine import AsyncBufferedEngine
    task, data, params, loss_fn = femnist_setup()
    fed = FedConfig(total_clients=8, clients_per_round=4, rounds=rounds,
                    k0=3, eta0=0.3, batch_size=4, seed=0,
                    **{**ASYNC_RUN, **fed_kw})
    return AsyncBufferedEngine(
        loss_fn, params, data, fed,
        RuntimeModel(task.model_size_mb, task.runtime, 4,
                     heterogeneity=het), backend=backend)


def async_result(eng) -> dict:
    return {"params": eng.params, "history": eng.history.as_dict(),
            "t_state": eng.transport_state,
            "server": eng.store.gather(eng.server_state),
            "hist": dict(eng.staleness_hist),
            "counts": (eng.compile_count, eng.shared_count,
                       eng.dispatch_count),
            "params_bytes": placed_bytes(eng.store.params)}


def run_async(backend, tmp=None, **fed_kw) -> dict:
    """``ASYNC_APPLIES`` applications straight; with ``tmp``, the
    checkpointed run (``ASYNC_CKPT``) straight, and saved after
    ``ASYNC_SAVE_AT`` (mid-buffer) into ``tmp``, restored into a fresh
    engine and resumed."""
    eng = async_engine(backend, **fed_kw)
    eng.run(ASYNC_APPLIES)
    out = {"straight": async_result(eng)}
    if tmp is not None:
        kw = {**fed_kw, **ASYNC_CKPT}
        eng = async_engine(backend, 0.0, **kw)
        eng.run(ASYNC_APPLIES)
        out["ckpt_straight"] = async_result(eng)
        a = async_engine(backend, 0.0, **kw)
        a.run(ASYNC_SAVE_AT)
        out["mid"] = (a._buf_count, len(a._heap))
        a.save_state(tmp)
        b = async_engine(backend, 0.0, **kw)
        b.restore_state(tmp)
        b.run(ASYNC_APPLIES)
        out["resumed"] = async_result(b)
    return out


def fleet_points():
    from repro_torch.api import ExperimentSpec
    from repro_torch.api.sweep import expand_sweep
    return list(expand_sweep(*FLEET_SWEEP, base=ExperimentSpec()
                             .with_overrides(*FLEET_BASE)))


def fleet_rank_part(mesh) -> dict:
    """The packed fleet on ``mesh``'s slices (every rank), each point's
    params and program key recorded where this rank ran it; then every
    point alone on this rank's slice, a fresh registry each."""
    from repro_torch.api import experiment
    from repro_torch.core.engine.backends.mesh import carve_submeshes
    from repro_torch.launch import fleet
    points = fleet_points()
    parent = MeshBackend(mesh)
    make, build = experiment._make_backend, fleet.build
    ran = {}

    def recording(spec, **kw):
        exp = build(spec, **kw)
        ran[spec.fed.k0, spec.transport.name] = (exp, kw["program_key"])
        return exp

    experiment._make_backend = lambda spec, device: parent
    fleet.build = recording
    try:
        res = fleet.run_fleet(points=points, packed=True, device="cpu")
    finally:
        experiment._make_backend, fleet.build = make, build
    mine = {key: {"params": exp.params, "key": pk}
            for key, (exp, pk) in ran.items()}
    rank = dist.get_rank()
    slices = carve_submeshes(mesh, len(points))
    own = next(m for m in slices if rank in m.mesh.reshape(-1).tolist())
    alone = {}
    for p in points:
        exp = build(p.spec, backend=MeshBackend(own), device="cpu")
        h = exp.run()
        tr = exp.trainer
        alone[p.spec.fed.k0, p.spec.transport.name] = {
            "params": exp.params, "final_loss": float(h.train_loss[-1]),
            "min_loss": float(min(h.min_train_loss)),
            "counts": (tr.compile_count, tr.dispatch_count)}
    return {"points": [(r.label, r.spec.fed.k0, r.spec.transport.name,
                        r.final_loss, r.min_loss, r.compile_count,
                        r.shared_count, r.dispatch_count)
                       for r in res.points],
            "fleet_counts": (res.compile_count, res.shared_count,
                             res.dispatch_count),
            "mine": mine, "alone": alone,
            "slices": [m.mesh.tolist() for m in slices],
            "own": own.mesh.tolist()}


def paths_rank_body(rank, world, tmp):
    """On 2 ranks ((2, 1) data x model): the streamed runs (flat), FSDP
    streamed runs beside their replicated twins, and the async runs
    (plain, resumed mid-buffer, under FSDP beside its twin). On 4 ranks
    ((2, 2) pod x data): the streamed runs with grouped reduce, and the
    packed fleet."""
    shape, names = MESHES[world]
    mesh = make_mesh(shape, names, "cpu")
    chunk = SLAB_C[world]
    reduce = "flat" if world == 2 else "grouped"
    res = {"rank": rank}
    for name, kw in SLAB_RUNS.items():
        with kernel_rows() as seen:
            res[f"slabs.{name}"] = run_slabs(
                MeshBackend(mesh, reduce=reduce), chunk, **kw)
        res[f"rows.{name}"] = seen
    if world == 2:
        _, _, params, _ = femnist_setup()
        specs = shard_specs(mesh, params, FSDP_RULE)
        for name, kw in SLAB_SHARDED.items():
            for tag, sp in (("plain", None), ("sharded", specs)):
                res[f"fsdp.{tag}.{name}"] = run_slabs(
                    MeshBackend(mesh, param_specs=sp), chunk, **kw)
        res["async"] = run_async(MeshBackend(mesh),
                                 os.path.join(tmp, f"async{rank}"))
        for tag, sp in (("plain", None), ("sharded", specs)):
            res[f"async.{tag}"] = run_async(
                MeshBackend(mesh, param_specs=sp),
                os.path.join(tmp, f"async_{tag}{rank}"),
                server_optimizer="fedavgm", server_lr=0.5)
    else:
        res["fleet"] = fleet_rank_part(mesh)
    return res


# ---------------------------------------------------------------------------
# the tensor-parallel prefill
# ---------------------------------------------------------------------------

def tp_rank_body(rank, world, models, cases, device="cpu"):
    """One rank of the tensor-parallel prefill's meshes: every case
    ``(key, shape, arch, batch, kw)`` through ``make_prefill_step(cfg,
    mesh=..., **kw)`` on the ([pod,] data, model) mesh of ``shape`` (built
    once a shape, in the cases' order, over this world) and
    ``models[arch]`` = (cfg, whole params). Returns {key: (logits, states,
    that case's collectives by kind, its kernel launches by wrapper)}, on
    the CPU (where the plain versions run and count no launch)."""
    from repro_torch.kernels import flash_attention, moe_gmm, ssd_scan
    mods = {"flash_attention": flash_attention, "gmm": moe_gmm,
            "ssd_scan": ssd_scan}
    meshes, out = {}, {}
    for key, shape, arch, batch, kw in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(
                shape, ("pod", "data", "model")[-len(shape):], device)
        cfg, params = models[arch]
        if device != "cpu":
            params = _to(params, device)
            batch = _to(batch, device)
        for kind in collectives.counts:
            collectives.counts[kind] = 0
        before = {k: m.launches for k, m in mods.items()}
        logits, states = make_prefill_step(cfg, mesh=meshes[shape], **kw)(
            params, batch)
        out[key] = (logits.cpu(), _to(states, "cpu"),
                    dict(collectives.counts),
                    {k: m.launches - before[k] for k, m in mods.items()})
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return None if tree is None else tree.to(device)


def _leaf_shapes(tree) -> dict:
    return {"/".join(k): tuple(t.shape) for k, t in sharding.iter_leaves(tree)}


def tpd_rank_body(rank, world, models, cases, device="cpu"):
    """One rank of the tensor-parallel decode's meshes. Each case ``(key,
    kind, shape, arch, tokens, kw)`` on the ([pod,] data, model) mesh of
    ``shape`` (built once a shape, in the cases' order) and
    ``models[arch]`` = (cfg, whole params):

    * ``"decode"``: ``registry.init_cache(..., mesh=)`` of ``kw``'s
      ``max_seq``, ``ring``, ``quant`` and ``long_mode``, then
      ``make_serve_step(cfg, mesh=...)`` teacher-forced through every
      column of ``tokens`` (B, T). Returns (logits (T, B, V), the gathered
      cache, every step's collectives by kind, the blocks' shapes, the
      whole cache's shapes, every step's kernel launches);
    * ``"handover"``: ``make_prefill_step(cfg, mesh=..., **kw)`` on the
      batch ``tokens`` with ``cache_blocks`` True and False: (the blocks
      gathered, the whole states, the blocks' shapes, each call's
      collectives by kind);
    * ``"dryrun"``: ``launch.dryrun.case_plan``'s cache bytes a rank for
      ``kw``'s arch and shape on this mesh, and the bytes of the blocks
      ``init_cache(mesh=)`` allocates on ``meta`` ((plan, allocated)).

    Results on the CPU."""
    from repro_torch.kernels import flash_attention, moe_gmm, ssd_scan
    mods = (flash_attention, moe_gmm, ssd_scan)
    meshes, out = {}, {}
    for key, kind, shape, arch, tokens, kw in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(
                shape, ("pod", "data", "model")[-len(shape):], device)
        mesh = meshes[shape]
        if kind == "dryrun":
            out[key] = _dryrun_bytes(mesh, **kw)
            continue
        cfg, params = models[arch]
        if device != "cpu":
            params, tokens = _to(params, device), tokens.to(device)
        if kind == "handover":
            for kind_ in collectives.counts:
                collectives.counts[kind_] = 0
            logits, blocks = make_prefill_step(
                cfg, mesh=mesh, cache_blocks=True, **kw)(
                    params, {"tokens": tokens})
            counts = dict(collectives.counts)
            for kind_ in collectives.counts:
                collectives.counts[kind_] = 0
            whole = make_prefill_step(cfg, mesh=mesh, **kw)(
                params, {"tokens": tokens})[1]
            out[key] = (_to(sharding.gather_cache(blocks), "cpu"),
                        _to(whole, "cpu"), _leaf_shapes(blocks),
                        (counts, dict(collectives.counts)))
            continue
        B, T = tokens.shape
        opts = {k: kw[k] for k in ("ring", "long_mode") if k in kw}
        cache = registry.init_cache(params, cfg, B, kw["max_seq"],
                                    quant=kw.get("quant", False), mesh=mesh,
                                    **opts)
        step = make_serve_step(cfg, mesh=mesh,
                               moe_path=kw.get("moe_path", "dispatch"),
                               **opts)
        logits, counts, launches = [], [], []
        for pos in range(T):
            for kind_ in collectives.counts:
                collectives.counts[kind_] = 0
            before = [m.launches for m in mods]
            got, same = step(params, cache, tokens[:, pos], pos)
            assert same is cache
            logits.append(got.cpu())
            counts.append(dict(collectives.counts))
            launches.append(sum(m.launches for m in mods) - sum(before))
        out[key] = (torch.stack(logits),
                    _to(dict(sharding.gather_cache(cache)), "cpu"),
                    counts, _leaf_shapes(cache),
                    _leaf_shapes(cache.layout.shapes), launches)
    return out


def _dryrun_bytes(mesh, arch, shape):
    """(the cache bytes a rank that ``case_plan`` counts for ``arch`` at
    the decode ``shape`` on ``mesh``, the bytes of the blocks
    ``init_cache(mesh=)`` allocates for it on ``meta``)."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun
    plan = dryrun.case_plan(arch, shape, False, mesh=mesh)
    leaves, specs = plan["groups"]["cache"]
    counted = sharding.block_bytes(leaves, specs,
                                   sharding.MeshShape.of(mesh))
    cfg, s = get_arch(arch), get_shape(shape)
    audio = (torch.empty((s.global_batch, cfg.encoder_seq, cfg.d_model),
                         dtype=dryrun.DTYPE, device="meta")
             if registry.is_encdec(cfg) else None)
    blocks = registry.init_cache(
        registry.shapes(cfg, dryrun.DTYPE), cfg, s.global_batch, s.seq_len,
        dryrun.DTYPE, audio, long_mode=s.name == "long_500k", mesh=mesh)
    return counted, sum(t.numel() * t.element_size()
                        for _, t in sharding.iter_leaves(blocks))


def _zero_counts():
    for kind in collectives.counts:
        collectives.counts[kind] = 0


def tpe_rank_body(rank, world, models, cases, device="cpu"):
    """One rank of the encoder-decoder's tensor-parallel meshes. Each case
    ``(key, shape, arch, tokens, audio, prompt, max_seq)`` on the ([pod,]
    data, model) mesh of ``shape`` (built once a shape, in the cases'
    order) and ``models[arch]`` = (cfg, whole params):
    ``make_prefill_step(cfg, mesh=...)`` on {the first ``prompt`` columns
    of tokens (B, T), audio}; ``registry.init_cache(...,
    audio_embeds=audio, mesh=)``; then ``make_serve_step(cfg, mesh=...)``
    teacher-forced through every column of ``tokens``. Returns {key:
    (the prefill's logits, the decode's logits (T, B, V), the gathered
    cache, the collectives by kind of the prefill, of ``init_cache`` and
    of every step, the blocks' shapes, the whole cache's shapes, the
    kernel launches of all of it)}, on the CPU."""
    from repro_torch.kernels import flash_attention, moe_gmm, ssd_scan
    mods = (flash_attention, moe_gmm, ssd_scan)
    meshes, out = {}, {}
    for key, shape, arch, tokens, audio, prompt, max_seq in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(
                shape, ("pod", "data", "model")[-len(shape):], device)
        mesh = meshes[shape]
        cfg, params = models[arch]
        if device != "cpu":
            params = _to(params, device)
            tokens, audio = tokens.to(device), audio.to(device)
        before = sum(m.launches for m in mods)
        B, T = tokens.shape
        _zero_counts()
        prefill = make_prefill_step(cfg, mesh=mesh)(
            params, {"tokens": tokens[:, :prompt], "audio_embeds": audio})
        counts = [dict(collectives.counts)]
        _zero_counts()
        cache = registry.init_cache(params, cfg, B, max_seq,
                                    audio_embeds=audio, mesh=mesh)
        counts.append(dict(collectives.counts))
        step = make_serve_step(cfg, mesh=mesh)
        logits = []
        for pos in range(T):
            _zero_counts()
            got, same = step(params, cache, tokens[:, pos], pos)
            assert same is cache
            logits.append(got.cpu())
            counts.append(dict(collectives.counts))
        out[key] = (prefill.cpu(), torch.stack(logits),
                    _to(dict(sharding.gather_cache(cache)), "cpu"), counts,
                    _leaf_shapes(cache), _leaf_shapes(cache.layout.shapes),
                    sum(m.launches for m in mods) - before)
    return out


# ---------------------------------------------------------------------------
# tensor-parallel training
# ---------------------------------------------------------------------------

def coll_rank_fns(mesh, sizes, r):
    """The block path's collectives, each as (its Function's forward, the
    plain function it must equal bit for bit, the rank's scalar of its
    input): rank ``r`` of the ``"model"`` axis of ``mesh``, blocks of
    ``sizes`` along dim 0. ``C`` is read whole by every rank, ``Cr`` is
    the rank's own (the readers of a partial)."""
    ax = "model"
    lo = sum(sizes[:r])
    mine = lambda t: t.narrow(0, lo, sizes[r])
    c = collectives
    return {
        "block": (lambda x: c.block_dim(x, mesh, ax, 0, sizes),
                  lambda x: mine(x).contiguous(),
                  lambda y, C, Cr: (torch.tanh(y) * mine(C)).sum()),
        "gather": (lambda x: c.gather_dim(x, mesh, ax, 0, sizes),
                   lambda x: c.all_gather_dim(x, mesh, ax, 0, sizes),
                   lambda y, C, Cr: (torch.tanh(y) * C).sum()),
        "gather_partial": (
            lambda x: c.gather_dim(x, mesh, ax, 0, sizes, partial=True),
            lambda x: c.all_gather_dim(x, mesh, ax, 0, sizes),
            lambda y, C, Cr: (torch.tanh(y) * Cr).sum()),
        "reduce_scatter": (
            lambda x: c.reduce_scatter_sum(x, mesh, ax, 0, sizes),
            lambda x: c.reduce_scatter_dim(x, mesh, ax, 0),
            lambda y, C, Cr: (torch.tanh(y) * mine(C)).sum()),
        "all_reduce": (lambda x: c.all_reduce_sum(x, mesh, ax),
                       lambda x: c.all_reduce_axis(x.clone(), mesh, ax),
                       lambda y, C, Cr: (torch.tanh(y) * C).sum()),
        "all_reduce_partial": (
            lambda x: c.all_reduce_sum(x, mesh, ax, partial=True),
            lambda x: c.all_reduce_axis(x.clone(), mesh, ax),
            lambda y, C, Cr: (torch.tanh(y) * Cr).sum()),
        "enter": (lambda x: c.enter(x, mesh, ax), lambda x: x,
                  lambda y, C, Cr: (torch.tanh(y) * Cr).sum()),
    }


def _coll_case(mesh, r, case):
    """Each collective's forward against its plain function, and the
    gradient of the rank's scalar under ``torch.func.grad`` and under
    ``vmap(grad)`` over the clients of ``case["batched"]``."""
    sizes = case["sizes"]
    C, Cr = case["C"], case["Cr"][r]
    out = {}
    for name, (fn, plain, scalar) in coll_rank_fns(mesh, sizes, r).items():
        x, xs = case["inputs"][name][r], case["batched"][name][r]
        with torch.no_grad():
            fwd_equal = torch.equal(fn(x), plain(x))
        f = lambda t: scalar(fn(t), C, Cr)
        _zero_counts()
        g = torch.func.grad(f)(x)
        counts = dict(collectives.counts)
        gv = torch.func.vmap(torch.func.grad(f))(xs)
        out[name] = (fwd_equal, g, gv, counts)
    return out


def _tp_grads(cfg, params, batch, mesh, kw):
    """One local step's whole gradient on this ``"model"`` rank: the
    loss on the rank (``registry.loss_fn(tp=ModelRank(train=True))``)
    under ``torch.func.grad``, then ``ModelGrads``' hook: the shared
    spans summed, the owned spans gathered from their owners."""
    from repro_torch.models import transformer
    tp = sharding.ModelRank(mesh, kw.get("act_spec"), kw.get("attn_kv_spec"),
                            kw.get("moe_spmd_axes"), train=True)
    loss_kw = {k: kw[k] for k in ("remat", "moe_path", "moe_shards",
                                  "moe_spmd_axes") if k in kw}
    fn = registry.loss_fn(cfg, tp=tp, **loss_kw)
    grads, (loss, _) = torch.func.grad_and_value(fn, has_aux=True)(params,
                                                                   batch)
    spread = transformer.moe_spreads(tp, kw.get("moe_path", "dispatch"),
                                     kw.get("moe_shards", 1))
    return sharding.ModelGrads(cfg, tp, params, spread).hook(gather=True)(
        grads, loss, batch)


def tpt_rank_body(rank, world, models, cases, device="cpu"):
    """One rank of the tensor-parallel train step's meshes. Each case
    ``(key, kind, shape, arch, inputs, kw)`` on the ([pod,] data, model)
    mesh of ``shape`` (built once a shape, in the cases' order) and
    ``models[arch]`` = (cfg, whole params):

    * ``"coll"``: the block path's collectives (``coll_rank_fns``) on
      ``inputs``, forward bit for bit, gradients under ``grad`` and
      ``vmap(grad)`` (``_coll_case``);
    * ``"grad"``: one local step's whole gradient on the batch ``inputs``
      (``_tp_grads``) -> (grads, loss, collectives by kind);
    * ``"round"``: ``make_fed_train_step(cfg, mesh=..., **kw)`` on
      (batches, weights, eta) = ``inputs``; ``kw["param_specs"]`` True
      takes ``param_pspecs`` on the mesh -> (new params, mean first loss,
      collectives by kind and their bytes, ms).

    Results on the CPU."""
    import time
    from repro_torch.distributed import make_fed_train_step
    meshes, out = {}, {}
    for key, kind, shape, arch, inputs, kw in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(
                shape, ("pod", "data", "model")[-len(shape):], device)
        mesh = meshes[shape]
        if kind == "coll":
            r = collectives.client_rank(mesh, ("model",))
            out[key] = _coll_case(mesh, r, inputs)
            continue
        cfg, params = models[arch]
        if device != "cpu":
            params = _to(params, device)
        _zero_counts()
        if kind == "grad":
            if device != "cpu":
                inputs = _to(inputs, device)
            grads, loss = _tp_grads(cfg, params, inputs, mesh, kw)
            out[key] = (_to(grads, "cpu"), float(loss),
                        dict(collectives.counts))
            continue
        kw = dict(kw)
        if kw.get("param_specs"):
            kw["param_specs"] = sharding.param_pspecs(
                cfg, params, sharding.MeshShape.of(mesh))
        for kind_ in collectives.counts:
            collectives.nbytes[kind_] = 0
        step = make_fed_train_step(cfg, mesh=mesh, device=device, **kw)
        t = time.perf_counter()
        new, loss = step(params, *inputs)
        if device != "cpu":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        out[key] = (_to(new, "cpu"), float(loss), dict(collectives.counts),
                    dict(collectives.nbytes), ms)
    return out
