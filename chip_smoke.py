#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

1. device   — card name, the ``nvidia-smi`` name/power-limit line (also
              printed alone), TF32 switched off for matmul and cuDNN so the
              CNN runs in f32 like the reference;
2. build    — nvcc builds every kernel from ``src/repro_torch/csrc``;
3. kernel   — each kernel against its plain PyTorch version at the shapes
              the main path gives it (every parameter leaf of the four
              paper models at its task's clients per round, plus odd,
              bf16 and N=1 shapes), with device times (median of 25
              calls, L2 flushed before each) for the kernel, the plain
              version and one library call, beside the bound the card's
              data-sheet bandwidth and f32 rate give for the same bytes and
              flops;
4. parity   — one narrow CIFAR100 round on the card (kernel) against the
              same round on the CPU (plain version);
5. main     — ``FedAvgTrainer`` with ``aggregator="kernel"`` on CIFAR100 at
              paper width (U=25, b=32, K0=50, eta0=0.01, K_r-rounds) for 4
              rounds plus one eval, then FEMNIST, Sent140 and Shakespeare at
              their paper FedConfigs for 2 rounds each; launch counts are
              zeroed before each run and must equal rounds x leaves after.

The line before the last is the kernels summary; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),        # tests/test_kernels.py:12
       # one bf16 ulp of the f32 sum rounded to bf16 (what the plain version
       # returns): a sum in another order may round to the neighbour
       "bfloat16": dict(rtol=2 ** -7, atol=1e-6)}
MAIN_TASKS = ("cifar100", "femnist", "sent140", "shakespeare")
# shapes held besides the main path's leaves: (label, N, M, dtype)
EXTRA_SHAPES = [("odd", 7, 8193, "float32"),
                ("odd.bf16", 50, 8193, "bfloat16"),
                ("n1", 1, 4096, "float32"),
                ("n1.bf16", 1, 8192, "bfloat16")]


def leaf_items(tree, prefix: str):
    """(path, tensor) of a nested dict of tensors, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in leaf_items(v, f"{prefix}.{k}")]
    return [(prefix, tree)]


def kernel_shapes():
    """Every leaf the main path reduces, (clients_per_round, leaf size) for
    each task's paper model, then ``EXTRA_SHAPES``; CIFAR100's eight leaves
    come first and make up one round of its aggregation."""
    from repro_torch.configs import get_paper_task
    from repro_torch.models import small
    shapes = []
    for name in MAIN_TASKS:
        task = get_paper_task(name)
        params = small.init_task_model(0, task, device="cpu")
        shapes += [(path, task.fed.clients_per_round, leaf.numel(),
                    "float32") for path, leaf in leaf_items(params, name)]
    return shapes + EXTRA_SHAPES


# rounds of the main path: CIFAR100 shows K = 50, 40, 35, 32; the other
# tasks two rounds each (Shakespeare's host-bound GRU takes ~13 s a round)
CIFAR_ROUNDS, OTHER_ROUNDS = 4, 2

# data-sheet peaks: (device bytes/s, f32 flop/s outside the tensor cores)
CARD_PEAKS = [("H100 PCIe", (2.0e12, 51e12)), ("H100 NVL", (3.9e12, 60e12)),
              ("H200", (4.8e12, 67e12)), ("H100", (3.35e12, 67e12))]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS:
        if key in name:
            return peaks
    raise SystemExit(f"no data-sheet peaks for card {name!r}")


def time_ms(torch, fn, flush, reps: int = 25) -> float:
    """Median device time of one call, from CUDA events around it, with the
    L2 cache flushed before each. The host does not wait between calls: it
    enqueues the call while the card still writes the 256 MB flush buffer,
    so the events see the kernels' time and not the host's launch cost."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    ptxas = [line.strip() for log in _build.build_logs.values()
             for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "ptxas": ptxas})


def phase_kernel(torch, bw: float, f32_peak: float):
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels.ref import fedavg_reduce_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20 // 4, device="cuda")  # > 50 MB L2
    rows, max_err = [], 0.0
    for label, n, m, dt in kernel_shapes():
        dtype = getattr(torch, dt)
        x = torch.randn((n, m), generator=gen, device="cuda").to(dtype)
        w = torch.softmax(torch.randn((n,), generator=gen, device="cuda"), 0)
        w_x = w.to(dtype)           # the library call takes one dtype
        out = fr.fedavg_reduce(x, w)
        again = fr.fedavg_reduce(x, w)
        want = fedavg_reduce_ref(x, w)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        torch.testing.assert_close(out.float(), want.float(), **TOL[dt])
        if not torch.equal(out, again):
            raise AssertionError(f"{label}: kernel not deterministic")
        es = x.element_size()
        nbytes = n * m * es + m * es + 4 * n
        flops = 2 * n * m
        t_bytes, t_ops = nbytes / bw * 1e3, flops / f32_peak * 1e3
        row = {
            "phase": "kernel", "name": "fedavg_reduce", "shape": label,
            "n": n, "m": m, "dtype": dt, "max_abs_err": err,
            "tol": TOL[dt],
            "path": ("vec" if m % (16 // es) == 0 else "scalar"),
            "ms": time_ms(torch, lambda: fr.fedavg_reduce(x, w), flush),
            "plain_ms": time_ms(torch, lambda: fedavg_reduce_ref(x, w),
                                flush),
            "library_ms": time_ms(
                torch, lambda: torch.einsum("c,cm->m", w_x, x), flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        emit(row)
        rows.append(row)
        max_err = max(max_err, err)
        del x, w_x, want, out, again
    return rows, max_err


def phase_parity(torch):
    """One narrow CIFAR100 round: kernel on the card vs plain on the CPU."""
    import numpy as np
    from repro_torch.configs import get_paper_task
    from repro_torch.core import make_round_fn
    from repro_torch.data import make_paper_task, pipeline
    from repro_torch.models import small
    from repro_torch.optim import tree_leaves
    task = get_paper_task("cifar100")
    data = make_paper_task("cifar100", np.random.default_rng(1),
                           num_clients=8, samples_per_client=16)
    params = small.cnn_init(torch.Generator().manual_seed(1), (32, 32, 3),
                            100, channels=(8, 16), hidden=32)
    rng = np.random.default_rng(1)
    ids = pipeline.sample_clients(rng, data, 4)
    batches = pipeline.round_batches(rng, data, ids, 3, 4)
    weights = pipeline.client_weights(data, ids)
    loss_fn = lambda p, b: small.task_loss(p, task, b)
    outs = {}
    for dev in ("cpu", "cuda"):
        round_fn, _ = make_round_fn(loss_fn, aggregator="kernel",
                                    device=dev)
        p = {k: {kk: vv.to(dev) for kk, vv in v.items()}
             for k, v in params.items()}
        outs[dev] = round_fn(p, batches, weights, 0.01, ())
    err = 0.0
    for a, b in zip(tree_leaves(outs["cpu"][0]) + [outs["cpu"][1]],
                    tree_leaves(outs["cuda"][0]) + [outs["cuda"][1]]):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
        err = max(err, float((b.cpu() - a).abs().max()))
    emit({"phase": "parity", "what": "narrow cifar100 round, cuda vs cpu",
          "max_abs_err": err, "tol": {"rtol": 1e-4, "atol": 1e-4}})


def run_task(torch, name: str, rounds: int):
    import numpy as np
    from repro_torch.configs import get_paper_task
    from repro_torch.core import FedAvgTrainer, RuntimeModel, make_eval_fn
    from repro_torch.data import make_paper_task
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.models import small
    from repro_torch.optim import tree_leaves
    task = get_paper_task(name)
    t0 = time.perf_counter()
    data = make_paper_task(name, np.random.default_rng(0))
    data_s = time.perf_counter() - t0
    fed = dataclasses.replace(task.fed, k_schedule="rounds",
                              aggregator="kernel", rounds=rounds)
    params = small.init_task_model(0, task)
    leaves = len(tree_leaves(params))
    loss_fn = lambda p, b: small.task_loss(p, task, b)
    trainer = FedAvgTrainer(
        loss_fn, params, data, fed,
        RuntimeModel(task.model_size_mb, task.runtime,
                     fed.clients_per_round),
        make_eval_fn(loss_fn, data))

    # instrumentation of this script only: each engine dispatch is one
    # round (host clock between synchronisations), and the aggregation's
    # device time comes from CUDA events around the tree reduce
    round_ms, reduce_events = [], []
    run_bucket, reduce_tree = trainer.engine.run_bucket, \
        ops.fedavg_reduce_tree

    def timed_bucket(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_bucket(*a)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_reduce(*a):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = reduce_tree(*a)
        ev[1].record()
        reduce_events.append(ev)
        return out

    trainer.engine.run_bucket = timed_bucket
    ops.fedavg_reduce_tree = timed_reduce
    torch.cuda.reset_peak_memory_stats()
    fr.launches = 0
    try:
        t0 = time.perf_counter()
        h = trainer.run(rounds, eval_every=rounds)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        ops.fedavg_reduce_tree = reduce_tree
    launches = fr.launches
    reduce_ms = [a.elapsed_time(b) for a, b in reduce_events]
    want_k = [min(max(math.ceil(fed.k0 / r ** (1.0 / 3.0)), fed.k_min),
                  fed.k0) for r in range(1, rounds + 1)]
    if h.k != want_k:
        raise AssertionError(f"{name}: K {h.k} != {want_k}")
    if not all(math.isfinite(v) for v in h.train_loss + h.val_error):
        raise AssertionError(f"{name}: non-finite loss {h.train_loss}")
    if launches != rounds * leaves:
        raise AssertionError(f"{name}: {launches} kernel launches, want "
                             f"{rounds} rounds x {leaves} leaves")
    for i in range(rounds):
        emit({"phase": "main", "task": name, "round": h.rounds[i],
              "k": h.k[i], "loss": h.train_loss[i], "ms": round_ms[i],
              "reduce_ms": reduce_ms[i],
              "reduce_share": reduce_ms[i] / round_ms[i]})
    emit({"phase": "main", "task": name, "summary": True,
          "clients_per_round": fed.clients_per_round,
          "batch_size": fed.batch_size, "k": h.k, "eta0": fed.eta0,
          "params": sum(p.numel() for p in tree_leaves(params)),
          "leaves": leaves, "launches": launches,
          "val_error": h.val_error[-1], "run_s": run_s,
          "data_build_s": data_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import repro_torch ({e}); run from the "
              f"root of a checkout", file=sys.stderr)
        return 1

    name, _ = phase_device(torch)
    bw, f32_peak = card_peaks(name)
    phase_build()
    rows, max_err = phase_kernel(torch, bw, f32_peak)
    phase_parity(torch)
    launches = run_task(torch, "cifar100", CIFAR_ROUNDS)
    for task in MAIN_TASKS[1:]:
        launches += run_task(torch, task, OTHER_ROUNDS)

    # one round of the CIFAR100 aggregation: the sum over its eight leaves
    cnn = [r for r in rows if r["shape"].startswith("cifar100.")]
    total = lambda key: sum(r[key] for r in cnn)
    emit({"kernels": [{
        "name": "fedavg_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:81",
        "launches": launches, "max_abs_err": max_err,
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in cnn)
                     else "operations"),
        "library_ms": total("library_ms")}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
