#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

1. device   — card name, the ``nvidia-smi`` name/power-limit line (also
              printed alone), TF32 switched off for matmul and cuDNN so the
              CNN runs in f32 like the reference;
2. build    — nvcc builds every kernel from ``src/repro_torch/csrc``, one
              process per source, all started together;
3. kernel   — each kernel against its plain PyTorch version at the shapes
              the paths give it, with device times (median of 25 calls, L2
              flushed before each) for the kernel, the plain version and one
              library call where there is one, beside the bound the card's
              data-sheet bandwidth and f32 rate give for the same bytes and
              flops. ``fedavg_reduce`` at every parameter leaf of the four
              paper models at its task's clients per round, plus odd, bf16
              and N=1 shapes; the four wire-path kernels at every CIFAR100
              (N=25) and FEMNIST (N=60) leaf, both int8 plane counts, top-k
              at S = ceil(0.1 M), plus the edge shapes (M % 16 != 0, M = 1,
              an empty payload, -1 padding, a duplicate index, bf16 ref);
              the top-k reduce must repeat bitwise;
4. parity   — one narrow CIFAR100 round on the card (kernels) against the
              same round on the CPU (plain versions), plain and with the
              int8 uplink and downlink (two rounds, the second from the
              CPU's state);
5. main     — ``FedAvgTrainer`` with ``aggregator="kernel"`` on CIFAR100 at
              paper width (U=25, b=32, K0=50, eta0=0.01, K_r-rounds) for 4
              rounds plus one eval, then FEMNIST, Sent140 and Shakespeare at
              their paper FedConfigs for 2 rounds each; launch counts are
              zeroed before each run and must equal rounds x leaves after;
6. wire     — ``FedAvgTrainer`` on CIFAR100 at paper width for 3 rounds in
              each of three codec configurations (int8 up / int8x2 down,
              int8x2 up / int8 down, top-k both ways at 10%); ms per round,
              each kernel's and the encoders' device ms per round, and launch
              counts that must equal rounds x leaves (x N for the per-row
              top-k reduce).

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


# the wire path's codec configurations (phase 6): (uplink, downlink)
WIRE_CONFIGS = [("int8", "int8x2"), ("int8x2", "int8"), ("topk", "topk")]
WIRE_ROUNDS, TOPK_FRAC = 3, 0.1
WIRE_TASKS = ("cifar100", "femnist")
# kernels of the wire path: the name in the kernels line, what it replaces
WIRE_KERNELS = {
    "int8_decompress_reduce": "src/repro/kernels/delta_codec.py:85",
    "int8_decode_apply": "src/repro/kernels/delta_codec.py:178",
    "topk_scatter_reduce": "src/repro/kernels/delta_codec.py:324",
    "topk_scatter_apply": "src/repro/kernels/delta_codec.py:356",
}


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
    from repro_torch.core import make_round_fn
    from repro_torch.data import pipeline
    from repro_torch.optim import tree_leaves
    data, params, loss_fn = _narrow_cifar()
    rng = np.random.default_rng(1)
    ids = pipeline.sample_clients(rng, data, 4)
    batches = pipeline.round_batches(rng, data, ids, 3, 4)
    weights = pipeline.client_weights(data, ids)
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


def wire_leaf_shapes():
    """(label, N, M) of every leaf the wire path encodes on the tasks of
    ``WIRE_TASKS``, at each task's clients per round."""
    from repro_torch.configs import get_paper_task
    from repro_torch.models import small
    shapes = []
    for name in WIRE_TASKS:
        task = get_paper_task(name)
        params = small.init_task_model(0, task, device="cpu")
        shapes += [(path, task.fed.clients_per_round, leaf.numel())
                   for path, leaf in leaf_items(params, name)]
    return shapes


def _row(name, label, shape, err, tol, t, plain, lib, nbytes, flops, bw,
         f32_peak):
    t_bytes, t_ops = nbytes / bw * 1e3, flops / f32_peak * 1e3
    row = {"phase": "kernel", "name": name, "shape": label, **shape,
           "max_abs_err": err, "tol": tol, "ms": t, "plain_ms": plain,
           "library_ms": lib, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    row["bound_share"] = row["bound_ms"] / row["ms"] if t else None
    emit(row)
    return row


def _check(torch, got, want, tol, what):
    """Max abs error of ``got`` against ``want``; raises beyond ``tol``:
    ``exact``, or an atol relative to the largest |want| (``rel_max``)."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if tol == "exact":
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bitwise equal, max err {err}")
    else:
        scale = float(want.abs().max()) if want.numel() else 0.0
        if err > tol["rel_max"] * scale:
            raise AssertionError(f"{what}: max err {err} > "
                                 f"{tol['rel_max']} x {scale}")
    return err


# sums over the clients in another order than the plain version's
REDUCE_TOL = {"rel_max": 1e-5}
# a duplicate index inside a row: its atomic adds land in any order
DUP_TOL = {"rel_max": 1e-6}


def phase_wire_kernels(torch, bw: float, f32_peak: float):
    """The four wire-path kernels against their plain versions, with
    times, at every wire leaf shape and the edge shapes."""
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 * 2 ** 20 // 4, device="cuda")
    dev = "cuda"
    rows = []

    def planes(n, m):
        q = torch.randint(-127, 128, (n, m), generator=gen, device=dev,
                          dtype=torch.int8)
        qr = torch.randint(-127, 128, (n, m), generator=gen, device=dev,
                           dtype=torch.int8)
        w = torch.softmax(torch.randn((n,), generator=gen, device=dev), 0)
        return q, qr, w * 1e-4, w * 1e-6

    def distinct_idx(n, s, m):
        return torch.stack([torch.randperm(m, generator=gen, device=dev)[:s]
                            for _ in range(n)]).to(torch.int32)

    def int8_rows(label, n, m, ref_dtype=torch.float32):
        q, qr, w1, wr = planes(n, m)
        for two in (False, True):
            args = (q, w1, qr if two else None, wr if two else None)
            got = dc.int8_decompress_reduce(*args)
            again = dc.int8_decompress_reduce(*args)
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: int8 reduce not repeatable")
            err = _check(torch, got, ref.int8_decompress_reduce_ref(*args),
                         REDUCE_TOL, f"int8_decompress_reduce {label}")
            k = 2 if two else 1
            rows.append(_row(
                "int8_decompress_reduce", label,
                {"n": n, "m": m, "planes": k}, err, REDUCE_TOL,
                time_ms(torch, lambda: dc.int8_decompress_reduce(*args),
                        flush),
                time_ms(torch, lambda: ref.int8_decompress_reduce_ref(*args),
                        flush), None,
                k * (n * m + 4 * n) + 4 * m, 2 * k * n * m, bw, f32_peak))
        refv = torch.randn((m,), generator=gen, device=dev).to(ref_dtype)
        s = torch.full((1,), 3e-3, device=dev)
        rs = torch.full((1,), 2e-5, device=dev)
        s_host = float(s)
        es = refv.element_size()
        for two in (False, True):
            args = (refv, q[0], s, qr[0] if two else None,
                    rs if two else None)
            err = _check(torch, dc.int8_decode_apply(*args),
                         ref.int8_decode_apply_ref(*args), "exact",
                         f"int8_decode_apply {label}")
            lib = (time_ms(torch, lambda: torch.add(refv, q[0],
                                                    alpha=s_host), flush)
                   if not two and ref_dtype == torch.float32 else None)
            k = 2 if two else 1
            rows.append(_row(
                "int8_decode_apply", label,
                {"m": m, "planes": k, "dtype": str(ref_dtype)[6:]}, err,
                "exact",
                time_ms(torch, lambda: dc.int8_decode_apply(*args), flush),
                time_ms(torch, lambda: ref.int8_decode_apply_ref(*args),
                        flush), lib,
                2 * m * es + k * (m + 4), 2 * k * m, bw, f32_peak))

    def topk_rows(label, n, m, ref_dtype=torch.float32, idx=None, tol="exact"):
        s = idx.shape[1] if idx is not None else math.ceil(TOPK_FRAC * m)
        idx = distinct_idx(n, s, m) if idx is None else idx
        vals = torch.randn(idx.shape, generator=gen, device=dev)
        w = torch.softmax(torch.randn((n,), generator=gen, device=dev), 0)
        got = dc.topk_scatter_reduce(vals, idx, w, m)
        again = dc.topk_scatter_reduce(vals, idx, w, m)
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: top-k reduce not repeatable")
        err = _check(torch, got, ref.topk_scatter_reduce_ref(vals, idx, w, m),
                     tol, f"topk_scatter_reduce {label}")
        flat_idx = idx.reshape(-1)
        lib = (time_ms(torch, lambda: torch.zeros(m, device=dev).index_add_(
            0, flat_idx, (vals * w[:, None]).reshape(-1)), flush)
            if bool((idx >= 0).all()) else None)
        rows.append(_row(
            "topk_scatter_reduce", label, {"n": n, "m": m, "s": s}, err, tol,
            time_ms(torch, lambda: dc.topk_scatter_reduce(vals, idx, w, m),
                    flush),
            time_ms(torch, lambda: ref.topk_scatter_reduce_ref(vals, idx, w,
                                                               m), flush),
            lib, 8 * n * s + 4 * n + 4 * m, 2 * n * s, bw, f32_peak))
        refv = torch.randn((m,), generator=gen, device=dev).to(ref_dtype)
        v0, i0 = vals[0].contiguous(), idx[0].contiguous()
        err = _check(torch, dc.topk_scatter_apply(refv, v0, i0),
                     ref.topk_scatter_apply_ref(refv, v0, i0), tol,
                     f"topk_scatter_apply {label}")
        lib = (time_ms(torch, lambda: refv.clone().index_add_(0, i0, v0),
                       flush)
               if ref_dtype == torch.float32 and bool((i0 >= 0).all())
               else None)
        es = refv.element_size()
        rows.append(_row(
            "topk_scatter_apply", label,
            {"m": m, "s": s, "dtype": str(ref_dtype)[6:]}, err, tol,
            time_ms(torch, lambda: dc.topk_scatter_apply(refv, v0, i0),
                    flush),
            time_ms(torch, lambda: ref.topk_scatter_apply_ref(refv, v0, i0),
                    flush), lib, 2 * m * es + 8 * s, s, bw, f32_peak))

    for label, n, m in wire_leaf_shapes():
        int8_rows(label, n, m)
        topk_rows(label, n, m)
    # edge shapes
    int8_rows("odd", 7, 8193)
    int8_rows("m1", 3, 1)
    int8_rows("odd.bf16", 7, 8193, torch.bfloat16)
    topk_rows("odd", 7, 8193)
    topk_rows("m1", 3, 1)
    topk_rows("odd.bf16", 7, 8193, torch.bfloat16)
    pad = distinct_idx(4, 100, 1000)
    pad[:, ::3] = -1                                  # -1 padding slots
    topk_rows("pad", 4, 1000, idx=pad)
    dup = distinct_idx(4, 100, 1000)
    dup[:, 1] = dup[:, 0]                             # a duplicate per row
    topk_rows("dup", 4, 1000, idx=dup, tol=DUP_TOL)
    # an empty payload: zeros and a copy of ref, no kernel launched
    before = dict(dc.launches)
    z = dc.topk_scatter_reduce(torch.zeros((3, 0), device=dev),
                               torch.zeros((3, 0), dtype=torch.int32,
                                           device=dev),
                               torch.ones(3, device=dev), 37)
    refv = torch.randn(37, device=dev)
    same = dc.topk_scatter_apply(refv, torch.zeros(0, device=dev),
                                 torch.zeros(0, dtype=torch.int32,
                                             device=dev))
    torch.cuda.synchronize()
    if z.any() or not torch.equal(same, refv) or dc.launches != before:
        raise AssertionError("empty top-k payload: not zeros / ref, or a "
                             "kernel was launched")
    emit({"phase": "kernel", "name": "topk_scatter_*", "shape": "empty",
          "ok": True})
    return rows


def _narrow_cifar():
    """Narrow CIFAR100 CNN, small data and its loss: the parity set-up."""
    import numpy as np
    import torch
    from repro_torch.configs import get_paper_task
    from repro_torch.data import make_paper_task
    from repro_torch.models import small
    task = get_paper_task("cifar100")
    data = make_paper_task("cifar100", np.random.default_rng(1),
                           num_clients=8, samples_per_client=16)
    params = small.cnn_init(torch.Generator().manual_seed(1), (32, 32, 3),
                            100, channels=(8, 16), hidden=32)
    return data, params, lambda p, b: small.task_loss(p, task, b)


def phase_parity_wire(torch):
    """Two narrow CIFAR100 rounds with the int8 uplink and downlink, on the
    card (kernels) and the CPU (plain versions); round 2 starts both from
    the CPU's state after round 1. Each leaf within one quantisation step
    of the round (its movement / 127) plus the plain parity tolerance: a
    value near a rounding boundary may quantise one step apart."""
    import numpy as np
    from repro_torch.core.engine.round import RoundEngine
    from repro_torch.data import pipeline
    from repro_torch.optim import tree_leaves, tree_map
    data, params, loss_fn = _narrow_cifar()
    rng = np.random.default_rng(2)
    engines = {dev: RoundEngine(loss_fn, aggregator="kernel",
                                transport="int8", downlink="int8",
                                device=dev) for dev in ("cpu", "cuda")}
    state = {"params": params,
             "t": engines["cpu"].init_transport_state(params),
             "d": engines["cpu"].init_downlink_state(params)}
    to = lambda tree, dev: tree_map(lambda t: t.to(dev), tree)
    err, worst = 0.0, 0.0
    for r in range(2):
        bb = pipeline.bucket_batches(rng, data, n_rounds=1, k=3,
                                     clients_per_round=4, batch_size=4)
        batches = {k: v[0] for k, v in bb.batches.items()}
        outs = {}
        for dev, eng in engines.items():
            eng.transport_state = to(state["t"], dev)
            eng.downlink_state = to(state["d"], dev)
            outs[dev] = eng.run_bucket(to(state["params"], dev), batches,
                                       bb.weights[0], 0.01, ())
        for old, a, b in zip(tree_leaves(state["params"]),
                             tree_leaves(outs["cpu"][0]),
                             tree_leaves(outs["cuda"][0])):
            step = float((a - old).abs().max()) / 127.0
            d = float((b.cpu() - a).abs().max())
            if d > 1e-4 + step:
                raise AssertionError(f"wire parity round {r + 1}: {d} > "
                                     f"1e-4 + one step {step}")
            err, worst = max(err, d), max(worst, d / (1e-4 + step))
        torch.testing.assert_close(outs["cuda"][1].cpu(), outs["cpu"][1],
                                   rtol=1e-4, atol=1e-4)
        eng = engines["cpu"]
        state = {"params": outs["cpu"][0], "t": eng.transport_state,
                 "d": eng.downlink_state}
    emit({"phase": "parity", "what": "narrow cifar100, int8 uplink + int8 "
          "downlink, 2 rounds, cuda vs cpu", "max_abs_err": err,
          "tol": "1e-4 + one quantisation step (round movement / 127)",
          "worst_share_of_tol": worst})


def run_wire(torch, data, up: str, down: str):
    """``FedAvgTrainer`` on CIFAR100 at paper width with one codec pair."""
    from repro_torch.configs import get_paper_task
    from repro_torch.core import FedAvgTrainer, RuntimeModel
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.models import small
    from repro_torch.optim import tree_leaves
    task = get_paper_task("cifar100")
    rounds = WIRE_ROUNDS
    fed = dataclasses.replace(task.fed, k_schedule="rounds",
                              aggregator="kernel", rounds=rounds,
                              transport=up, downlink=down,
                              topk_frac=TOPK_FRAC)
    params = small.init_task_model(0, task)
    leaves, n = len(tree_leaves(params)), fed.clients_per_round
    loss_fn = lambda p, b: small.task_loss(p, task, b)
    trainer = FedAvgTrainer(loss_fn, params, data, fed,
                            RuntimeModel(task.model_size_mb, task.runtime, n))

    # instrumentation of this script only: host clock around each round,
    # CUDA events around each kernel entry point and each encoder
    round_ms, events = [], {}
    run_bucket = trainer.engine.run_bucket

    def timed_bucket(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_bucket(*a)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed(key, fn):
        def call(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            events.setdefault(key, []).append(ev)
            return out
        return call

    entry = {"int8_decompress_reduce": "int8_delta_reduce",
             "int8_decode_apply": "int8_delta_apply",
             "topk_scatter_reduce": "topk_delta_reduce",
             "topk_scatter_apply": "topk_delta_apply"}
    saved = {fn: getattr(ops, fn) for fn in entry.values()}
    for key, fn in entry.items():
        setattr(ops, fn, timed(key, saved[fn]))
    trainer.engine.run_bucket = timed_bucket
    codecs = {"encode_up": trainer.engine.transport,
              "encode_down": trainer.engine.downlink.codec}
    for key, codec in codecs.items():
        codec.encode = timed(key, codec.encode)
    torch.cuda.reset_peak_memory_stats()
    for k in dc.launches:
        dc.launches[k] = 0
    fr.launches = 0
    try:
        t0 = time.perf_counter()
        h = trainer.run(rounds)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        for fn, f in saved.items():
            setattr(ops, fn, f)
    launches = dict(dc.launches)
    want = {k: 0 for k in launches}
    kind = lambda codec: "int8" if codec.startswith("int8") else "topk"
    want[{"int8": "int8_decompress_reduce",
          "topk": "topk_scatter_reduce"}[kind(up)]] = rounds * leaves * (
        n if kind(up) == "topk" else 1)     # one top-k launch per row
    want[{"int8": "int8_decode_apply",
          "topk": "topk_scatter_apply"}[kind(down)]] = rounds * leaves
    if launches != want or fr.launches != 0:
        raise AssertionError(f"wire {up}/{down}: launches {launches} "
                             f"(fedavg_reduce {fr.launches}), want {want}")
    want_k = [min(max(math.ceil(fed.k0 / r ** (1.0 / 3.0)), fed.k_min),
                  fed.k0) for r in range(1, rounds + 1)]
    if h.k != want_k:
        raise AssertionError(f"wire {up}/{down}: K {h.k} != {want_k}")
    if not all(math.isfinite(v) for v in h.train_loss):
        raise AssertionError(f"wire {up}/{down}: loss {h.train_loss}")
    dev_ms = {key: [a.elapsed_time(b) for a, b in evs]
              for key, evs in events.items()}
    per_round = {key: sum(v) / rounds for key, v in dev_ms.items()}
    for i in range(rounds):
        emit({"phase": "wire", "uplink": up, "downlink": down,
              "round": h.rounds[i], "k": h.k[i], "loss": h.train_loss[i],
              "ms": round_ms[i],
              "uplink_mbit": h.uplink_mbit[i],
              "downlink_mbit": h.downlink_mbit[i]})
    emit({"phase": "wire", "uplink": up, "downlink": down, "summary": True,
          "clients_per_round": n, "leaves": leaves, "k": h.k,
          "launches": launches, "device_ms_per_round": per_round,
          "ms_per_round": sum(round_ms) / rounds, "run_s": run_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


def paper_data(name: str):
    """The task's paper-scale data from seed 0, and the seconds it took."""
    import numpy as np
    from repro_torch.data import make_paper_task
    t0 = time.perf_counter()
    data = make_paper_task(name, np.random.default_rng(0))
    return data, time.perf_counter() - t0


def run_task(torch, name: str, rounds: int, data=None, data_s=None):
    from repro_torch.configs import get_paper_task
    from repro_torch.core import FedAvgTrainer, RuntimeModel, make_eval_fn
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.models import small
    from repro_torch.optim import tree_leaves
    task = get_paper_task(name)
    if data is None:
        data, data_s = paper_data(name)
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
    wrows = phase_wire_kernels(torch, bw, f32_peak)
    phase_parity(torch)
    phase_parity_wire(torch)
    cifar, cifar_s = paper_data("cifar100")
    launches = run_task(torch, "cifar100", CIFAR_ROUNDS, cifar, cifar_s)
    for task in MAIN_TASKS[1:]:
        launches += run_task(torch, task, OTHER_ROUNDS)
    wire_launches = dict.fromkeys(WIRE_KERNELS, 0)
    for up, down in WIRE_CONFIGS:
        for k, v in run_wire(torch, cifar, up, down).items():
            wire_launches[k] += v
    if not all(wire_launches.values()):
        raise AssertionError(f"a wire kernel never ran: {wire_launches}")

    # one CIFAR100 round: the sums over its eight leaves (for the int8
    # kernels, the one-plane codec's round)
    def summary(name, source, replaces, n_launches, rows_of, err):
        cnn = [r for r in rows_of if r["shape"].startswith("cifar100.")]
        total = lambda key: sum(r[key] for r in cnn)
        libs = [r["library_ms"] for r in cnn]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": total("ms"),
                "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
                "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                            for r in cnn) else "operations"),
                "library_ms": (sum(libs) if all(v is not None for v in libs)
                               else None)}

    kernels = [summary("fedavg_reduce",
                       "src/repro_torch/csrc/fedavg_reduce.cu",
                       "src/repro/kernels/fedavg_reduce.py:81", launches,
                       rows, max_err)]
    for kname, replaces in WIRE_KERNELS.items():
        mine = [r for r in wrows if r["name"] == kname]
        err = max(r["max_abs_err"] for r in mine)
        per_round = [r for r in mine if r.get("planes", 1) == 1]
        kernels.append(summary(kname, "src/repro_torch/csrc/delta_codec.cu",
                               replaces, wire_launches[kname], per_round,
                               err))
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
