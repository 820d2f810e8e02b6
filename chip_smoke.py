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
              and N=1 shapes, then ``fedavg_reduce_tree`` on each task's
              whole tree as one call (one launch, bitwise the per-leaf
              calls), beside the per-leaf sums and the call's host time;
              ``fedavg_reduce``, ``int8_decompress_reduce`` and
              ``int8_decode_apply`` rows also carry ``ms_clean`` (and
              ``library_ms_clean``), timed after a flush that only reads;
              the four wire-path kernels at every CIFAR100
              (N=25) and FEMNIST (N=60) leaf, both int8 plane counts, top-k
              at S = ceil(0.1 M), at qwen1.5-0.5b's embedding leaf (N 4, M
              155,582,464; top-k at S = ceil(0.25 M)) beside
              ``fedavg_reduce``'s row there, plus the edge shapes (M % 16 != 0, M = 1,
              an empty payload, -1 padding, a duplicate index, bf16 ref)
              and a collision-heavy top-k payload (every row the same
              indices, values of +-1e8 and +-1, at N = 25 and 60, where
              another order of the rows changes the sum); the top-k kernels
              must equal their plain versions exactly and repeat bitwise,
              the apply in bf16 too at every leaf;
4. parity   — one narrow CIFAR100 round on the card (kernels) against the
              same round on the CPU (plain versions), plain and with the
              int8 uplink and downlink (two rounds, the second from the
              CPU's state); one ``FedAvgTrainer`` round of reduced
              qwen1.5-0.5b (int8 uplink) and of reduced phi3.5-moe
              (dispatch path, kernel aggregator), card against CPU;
5. main     — ``FedAvgTrainer`` with ``aggregator="kernel"`` on CIFAR100 at
              paper width (U=25, b=32, K0=50, eta0=0.01, K_r-rounds) for 4
              rounds plus one eval, then FEMNIST, Sent140 and Shakespeare at
              their paper FedConfigs for 2 rounds each; launch counts are
              zeroed before each run and must equal the rounds after (one
              ``fedavg_reduce`` launch a round for the whole tree);
6. wire     — ``FedAvgTrainer`` on CIFAR100 at paper width for 3 rounds in
              each of three codec configurations (int8 up / int8x2 down,
              int8x2 up / int8 down, top-k both ways at 10%); ms per round,
              each kernel's and the encoders' device ms per round, and launch
              counts that must equal rounds x leaves (one launch a call
              for every kernel, the top-k reduce included);
7. lm       — the dense LM serving path. Phase ``kernel`` rows hold
              ``flash_attention`` against its plain version at the prefill
              shape and edge shapes (GQA, window, softcap, hd 128 and 32,
              non-causal, Sq = 1 against Sk = 257), in f32 (the
              ``"wgmma_split"`` path: bf16 hi + lo planes, three products)
              and bf16 (``"wgmma"``; also a ragged 300 x 300 tile, hd 16 and
              phi3.5-moe's attention shape), each row with the path it
              launched, times, the SDPA time and the bound (f32 rows: three
              bf16 products at the bf16 rate); phase
              ``parity`` runs reduced qwen1.5-0.5b and gemma2-27b on the
              card (kernel) against the CPU (plain): prefill logits and
              states, 8 greedy tokens; then qwen1.5-0.5b at full width
              (463,987,712 f32 params): prefill B 2 x S 4096 through the
              kernel (24 launches each, all on ``"wgmma_split"``; ms and
              the kernel's share), the same
              batch through the plain path, and ``ServingLoop`` greedy
              decode at the launcher's defaults (batch 4, prompt 16, 32
              tokens): tokens/s and peak memory; then the same prefill in
              bf16 (the f32 model cast on the card): 24 launches a prefill,
              all on ``"wgmma"``, and no further from the plain f32 path on
              the bf16 weights than ``BF16_ANCHOR_FACTOR`` x the plain bf16
              path is;
8. moe      — the MoE serving path. Phase ``kernel`` rows hold ``gmm``
              against its plain version (bitwise repeat too) at the
              phi3.5-moe prefill's gate/up and down shapes, the reference
              sweep's, the decode-dispatch floor C = 8 and one row of widths
              no multiple of 8, f32 (``"wgmma_split"``; ``"fma"`` for the
              unaligned row) and bf16 (``"wgmma"``; ``"fma"`` unaligned),
              with the path launched, the ``torch.bmm`` time and the bound;
              phase ``parity``
              adds reduced phi3.5-moe-42b-a6.6b and mixtral-8x22b (routing
              ids too, decode on the serving loop's dense MoE path); then
              phi3.5-moe-42b-a6.6b at full width and 8 of its 32 layers
              (10.7 B f32 params from seed 0): prefill B 2 x S 4096 through
              ``flash_attention`` and ``gmm`` (3 x layers gmm and layers
              flash launches each, all on ``"wgmma_split"``; ms, each
              kernel's share), the plain path
              on the same batch (logits, states, routing flips), and
              ``ServingLoop`` dense-path decode: tokens/s, peak memory; then
              the same prefill in bf16 (the f32 model cast on the card to
              21 GB): 24 gmm and 8 flash launches a prefill, all on
              ``"wgmma"``, held to the plain f32 path on the bf16 weights
              as in phase lm (both plain paths with the kernel run's
              routing ids);
9. ssm      — the SSM serving path. Phase ``kernel`` rows hold ``ssd_scan``
              against its plain version at the mamba2-780m prefill shape
              first, then the reference sweep, zamba2-7b's widths, the
              reduced configs' chunk 32, a ragged S, S < chunk and bf16, each
              row with the path it launched (f32 ``"fma"``, bf16
              ``"wgmma"``), times and the bound (no single library call
              computes the scan); phase ``parity`` adds reduced
              mamba2-780m, zamba2-7b and a 5-layer hybrid with the shared
              attention block (prefill logits, SSM and conv states, 8
              greedy tokens); then
              mamba2-780m at full width and depth (48 layers, 857,379,072
              f32 params from seed 0): prefill B 2 x S 4096 through
              ``ssd_scan`` (48 launches each; ms, the kernel's share), the
              plain path on the same batch, and ``ServingLoop`` greedy
              decode through the SSM and conv states: tokens/s, peak memory;
              then the same prefill in bf16 (the f32 model cast on the
              card): 48 launches a prefill, all on ``"wgmma"``, held to the
              plain f32 path on the bf16 weights as in phase lm; then
              zamba2-7b at full width (81 layers, 5,737,416,000 f32
              params): the same through ``ssd_scan`` (68 mamba layers) and
              ``flash_attention`` at head_dim 112 (13 shared-block layers,
              on ``"wgmma_split"``),
              whose rows at hd 112 and 192 (nemotron-4-340b) phase
              ``kernel`` holds too;
10. mesh    — the multi-device round at one rank over NCCL: the four
              client-sharded wrappers (kernel on this rank's rows, then the
              collective) against their plain sharded versions at every
              CIFAR100 leaf, with times; then ``FedAvgTrainer`` with a
              ``MeshBackend`` on CIFAR100 at paper width for 2 rounds with
              the plain uplink and each wire pair, and 1 round of grouped
              reduce on a (1, 1) ("pod", "data") mesh, each bitwise
              against the same rounds on ``LocalBackend``; launch and
              collective counts exact; ms per round, mesh and local, and
              the all-reduces' device ms per round;
11. lm_train — federated LM training at full width: ``FedAvgTrainer`` on
              qwen1.5-0.5b (phase lm's f32 params) over
              ``make_lm_clients`` data at the LM specs' traffic (12
              clients, 4 a round, b 4, seq 32, K_r-rounds, beta 0.05 s),
              3 rounds each of (a) int8 uplink, (b) int8 both ways, (c) a
              fixed cohort [0, 3, 5, 9] with top-k 0.25 and per-client
              error feedback, (d) no codec, the kernel aggregator; ms per
              round, ms per local step (CUDA events around the vmapped
              client update), each kernel's and encoder's device ms,
              launches (rounds x leaves for the wire kernels, rounds for the
              tree reduce), peak memory; K_r, sgd_steps, wall_clock_s and
              the wire Mbit exact against the RuntimeModel formula; losses
              finite. Then one round more, not counted or timed, whose
              every kernel call (each of the tree's 14 leaf sizes) is held
              against its plain version on the same inputs. Runs after
              phase lm.

The line before the last is the kernels summary (``flash_attention``,
``gmm`` and ``ssd_scan`` with their f32 and bf16 rows, paths and launches;
the wire kernels and ``fedavg_reduce`` with their launches in phase
lm_train and their row at qwen's embedding leaf);
the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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
    each task's paper model, then ``EXTRA_SHAPES`` and qwen1.5-0.5b's
    embedding leaf at 4 clients (``LM_LEAF``, phase ``lm_train``);
    CIFAR100's eight leaves come first and make up one round of its
    aggregation."""
    from repro_torch.configs import get_paper_task
    from repro_torch.models import small
    shapes = []
    for name in MAIN_TASKS:
        task = get_paper_task(name)
        params = small.init_task_model(0, task, device="cpu")
        shapes += [(path, task.fed.clients_per_round, leaf.numel(),
                    "float32") for path, leaf in leaf_items(params, name)]
    return shapes + EXTRA_SHAPES + [(*LM_LEAF, "float32")]


# rounds of the main path: CIFAR100 shows K = 50, 40, 35, 32; the other
# tasks two rounds each (Shakespeare's host-bound GRU takes ~13 s a round)
CIFAR_ROUNDS, OTHER_ROUNDS = 4, 2

# data-sheet peaks: (device bytes/s, f32 flop/s outside the tensor cores,
# dense bf16 tensor-core flop/s)
CARD_PEAKS = [("H100 PCIe", (2.0e12, 51e12, 756e12)),
              ("H100 NVL", (3.9e12, 60e12, 835e12)),
              ("H200", (4.8e12, 67e12, 989e12)),
              ("H100", (3.35e12, 67e12, 989e12))]


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


def time_ms(torch, fn, flush, reps: int = 25, clean: bool = False) -> float:
    """Median device time of one call, from CUDA events around it, with the
    L2 cache flushed before each. The host does not wait between calls: it
    enqueues the call while the card still writes the 256 MB flush buffer,
    so the events see the kernels' time and not the host's launch cost.
    The flush writes the buffer, which leaves up to 50 MB of dirty lines
    in L2 for the timed call to write back; ``clean`` flushes by reading
    the buffer (a sum over it) instead, so the call finds clean lines."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def host_ms(torch, fn, reps: int = 25) -> float:
    """Median host time of one call, from the host clock around it, with
    the card idle before each."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


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
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line]
             for name, log in _build.build_logs.items()}
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
        path = "vec" if fr.last_plans[0].leaves[0].vec else "scalar"
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
            "path": path,
            "ms": time_ms(torch, lambda: fr.fedavg_reduce(x, w), flush),
            "ms_clean": time_ms(torch, lambda: fr.fedavg_reduce(x, w),
                                flush, clean=True),
            "plain_ms": time_ms(torch, lambda: fedavg_reduce_ref(x, w),
                                flush),
            "library_ms": time_ms(
                torch, lambda: torch.einsum("c,cm->m", w_x, x), flush),
            "library_ms_clean": time_ms(
                torch, lambda: torch.einsum("c,cm->m", w_x, x), flush,
                clean=True),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        emit(row)
        rows.append(row)
        max_err = max(max_err, err)
        del x, w_x, want, out, again
    for task in MAIN_TASKS:
        row = tree_row(torch, task, rows, gen, flush, bw, f32_peak)
        rows.append(row)
        max_err = max(max_err, row["max_abs_err"])
    return rows, max_err


def tree_row(torch, task, leaf_rows, gen, flush, bw: float, f32_peak: float):
    """``fedavg_reduce_tree`` on the task's own leaves at paper N, timed as
    one call (one launch), against the per-leaf kernel calls (bitwise) and
    the plain tree (per leaf, at TOL); beside it the plain tree as one
    call, the sums of the per-leaf rows' kernel and ``torch.einsum``
    times, ``torch.einsum`` over the leaves timed as one call
    (``library_tree_ms``), the bound of the whole round's bytes, and
    ``host_ms``, the host's time for the call with the card idle: where
    it outlasts the flush, the events around a call see it."""
    from repro_torch.configs import get_paper_task
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fedavg_reduce_ref
    from repro_torch.models import small
    from repro_torch.optim import tree_leaves, tree_map
    cfg = get_paper_task(task)
    n = cfg.fed.clients_per_round
    params = small.init_task_model(0, cfg, device="cpu")
    tree = tree_map(lambda p: torch.randn((n,) + tuple(p.shape),
                                          generator=gen, device="cuda"),
                    params)
    w = torch.softmax(torch.randn((n,), generator=gen, device="cuda"), 0)
    flats = [x.reshape(n, -1) for x in tree_leaves(tree)]
    before = fr.launches
    got = tree_leaves(ops.fedavg_reduce_tree(tree, w))
    launches = fr.launches - before
    err = 0.0
    for x, g in zip(flats, got):
        if not torch.equal(g.reshape(-1), fr.fedavg_reduce(x, w)):
            raise AssertionError(f"{task} tree: not bitwise the per-leaf "
                                 f"kernel")
        want = fedavg_reduce_ref(x, w)
        torch.testing.assert_close(g.reshape(-1), want, **TOL["float32"])
        err = max(err, float((g.reshape(-1) - want).abs().max()))
    if launches != 1:
        raise AssertionError(f"{task} tree: {launches} launches, want 1")
    mine = [r for r in leaf_rows if r["shape"].startswith(f"{task}.")]
    total = lambda key: sum(r[key] for r in mine)
    nbytes = sum(r["bytes"] for r in mine)
    t_bytes, t_ops = nbytes / bw * 1e3, 2 * n * sum(
        r["m"] for r in mine) / f32_peak * 1e3
    call = lambda: ops.fedavg_reduce_tree(tree, w)
    row = {"phase": "kernel", "name": "fedavg_reduce_tree",
           "shape": f"{task}.tree", "n": n, "leaves": len(flats),
           "launches": launches, "dtype": "float32", "max_abs_err": err,
           "tol": TOL["float32"], "bitwise_per_leaf": True,
           "ms": time_ms(torch, call, flush),
           "ms_clean": time_ms(torch, call, flush, clean=True),
           "plain_ms": time_ms(torch, lambda: [fedavg_reduce_ref(x, w)
                                               for x in flats], flush),
           "host_ms": host_ms(torch, call),
           "per_leaf_ms": total("ms"), "library_ms": total("library_ms"),
           "library_ms_clean": total("library_ms_clean"),
           "library_tree_ms": time_ms(torch, lambda: [
               torch.einsum("c,cm->m", w, x) for x in flats], flush),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    emit(row)
    return row


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
         peak, **extra):
    """One kernel row; ``peak`` is the flop rate of the inputs' type;
    ``extra``: more times of the same row (``ms_clean``)."""
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    row = {"phase": "kernel", "name": name, "shape": label, **shape,
           "max_abs_err": err, "tol": tol, "ms": t, "plain_ms": plain,
           "library_ms": lib, **extra, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "flops": flops, "bytes_bound_ms": t_bytes,
           "flops_bound_ms": t_ops}
    row["bound_share"] = row["bound_ms"] / row["ms"] if t else None
    emit(row)
    return row


def path_peak(path: str, f32_peak: float, bf16_peak: float) -> float:
    """The flop rate a kernel path computes the function's flops at:
    ``"fma"`` f32 on the CUDA cores; ``"wgmma"`` bf16 on the tensor cores;
    ``"wgmma_split"`` three bf16 products for each f32 product, so a
    third of the bf16 rate."""
    return {"fma": f32_peak, "wgmma": bf16_peak,
            "wgmma_split": bf16_peak / 3}[path]


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
# the bf16 apply rounds to bf16 once per add of a duplicate index
BF16_DUP_TOL = {"rel_max": 2 ** -7}
# the top-k kernels' design (csrc/delta_codec.cu): one cooperative launch
# a call, a grid barrier between client rows (one block for short rows)
TOPK_DESIGN = "grid"


def collide_payload(torch, gen, n: int, s: int, m: int):
    """(N, S) top-k payload on which the order of the rows shows: every
    row holds the same S indices, each row in its own order, with values of
    +-1e8 and +-1, so a sum that takes the rows out of order rounds
    differently."""
    base = torch.randperm(m, generator=gen, device="cuda")[:s]
    idx = torch.stack([base[torch.randperm(s, generator=gen, device="cuda")]
                       for _ in range(n)]).to(torch.int32)
    mag = torch.tensor([1e8, -1e8, 1.0, -1.0], device="cuda")
    vals = mag[torch.randint(0, 4, (n, s), generator=gen, device="cuda")]
    return vals, idx


def phase_wire_kernels(torch, bw: float, f32_peak: float):
    """The four wire-path kernels against their plain versions, with
    times, at every wire leaf shape, qwen1.5-0.5b's embedding leaf
    (``LM_LEAF``; top-k at ``LM_TOPK_FRAC``) and the edge shapes."""
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
                k * (n * m + 4 * n) + 4 * m, 2 * k * n * m, bw, f32_peak,
                ms_clean=time_ms(
                    torch, lambda: dc.int8_decompress_reduce(*args), flush,
                    clean=True)))
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
            library = lambda: torch.add(refv, q[0], alpha=s_host)
            one_f32 = not two and ref_dtype == torch.float32
            k = 2 if two else 1
            rows.append(_row(
                "int8_decode_apply", label,
                {"m": m, "planes": k, "dtype": str(ref_dtype)[6:]}, err,
                "exact",
                time_ms(torch, lambda: dc.int8_decode_apply(*args), flush),
                time_ms(torch, lambda: ref.int8_decode_apply_ref(*args),
                        flush),
                time_ms(torch, library, flush) if one_f32
                else None,
                2 * m * es + k * (m + 4), 2 * k * m, bw, f32_peak,
                ms_clean=time_ms(torch, lambda: dc.int8_decode_apply(*args),
                                 flush, clean=True),
                library_ms_clean=(time_ms(torch, library, flush, clean=True)
                                  if one_f32 else None)))

    def topk_rows(label, n, m, ref_dtype=torch.float32, idx=None, tol="exact",
                  vals=None, w=None, frac=TOPK_FRAC):
        s = idx.shape[1] if idx is not None else math.ceil(frac * m)
        idx = distinct_idx(n, s, m) if idx is None else idx
        if vals is None:
            vals = torch.randn(idx.shape, generator=gen, device=dev)
        if w is None:
            w = torch.softmax(torch.randn((n,), generator=gen, device=dev), 0)
        got = [dc.topk_scatter_reduce(vals, idx, w, m) for _ in range(3)]
        if not all(torch.equal(got[0], g) for g in got[1:]):
            raise AssertionError(f"{label}: top-k reduce not repeatable")
        err = _check(torch, got[0],
                     ref.topk_scatter_reduce_ref(vals, idx, w, m), tol,
                     f"topk_scatter_reduce {label}")
        flat_idx = idx.reshape(-1)
        lib = (time_ms(torch, lambda: torch.zeros(m, device=dev).index_add_(
            0, flat_idx, (vals * w[:, None]).reshape(-1)), flush)
            if bool((idx >= 0).all()) else None)
        rows.append(_row(
            "topk_scatter_reduce", label,
            {"n": n, "m": m, "s": s, "design": TOPK_DESIGN}, err, tol,
            time_ms(torch, lambda: dc.topk_scatter_reduce(vals, idx, w, m),
                    flush),
            time_ms(torch, lambda: ref.topk_scatter_reduce_ref(vals, idx, w,
                                                               m), flush),
            lib, 8 * n * s + 4 * n + 4 * m, 2 * n * s, bw, f32_peak))
        v0, i0 = vals[0].contiguous(), idx[0].contiguous()
        # the apply in bf16 at every shape, checked only; timed in ref_dtype
        for dt in dict.fromkeys((ref_dtype, torch.bfloat16)):
            refv = torch.randn((m,), generator=gen, device=dev).to(dt)
            outs = [dc.topk_scatter_apply(refv, v0, i0) for _ in range(2)]
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"{label}: top-k apply not repeatable")
            _check(torch, outs[0], ref.topk_scatter_apply_ref(refv, v0, i0),
                   BF16_DUP_TOL if tol != "exact" and dt == torch.bfloat16
                   else tol, f"topk_scatter_apply {label} {dt}")
        refv = torch.randn((m,), generator=gen, device=dev).to(ref_dtype)
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
            {"m": m, "s": s, "dtype": str(ref_dtype)[6:],
             "design": TOPK_DESIGN}, err, tol,
            time_ms(torch, lambda: dc.topk_scatter_apply(refv, v0, i0),
                    flush),
            time_ms(torch, lambda: ref.topk_scatter_apply_ref(refv, v0, i0),
                    flush), lib, 2 * m * es + 8 * s, s, bw, f32_peak))

    for label, n, m in wire_leaf_shapes():
        int8_rows(label, n, m)
        topk_rows(label, n, m)
    # qwen1.5-0.5b's embedding leaf, the largest of phase lm_train
    int8_rows(*LM_LEAF)
    topk_rows(*LM_LEAF, frac=LM_TOPK_FRAC)
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
    # collision-heavy: the sum must follow the client order, which shows
    for n in (25, 60):
        vals, idx = collide_payload(torch, gen, n, 100_000, 1_000_000)
        w = torch.ones(n, device=dev)
        if torch.equal(ref.topk_scatter_reduce_ref(vals, idx, w, 1_000_000),
                       ref.topk_scatter_reduce_ref(vals.flip(0), idx.flip(0),
                                                   w, 1_000_000)):
            raise AssertionError("collision payload: the row order does "
                                 "not show")
        topk_rows(f"collide.n{n}", n, 1_000_000, idx=idx, vals=vals, w=w)
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
          "topk": "topk_scatter_reduce"}[kind(up)]] = rounds * leaves
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
    # round (host clock between synchronisations); CUDA events around the
    # tree reduce, which span the card's wait for the host's enqueue when
    # the card is idle, and the host clock around the same call
    round_ms, reduce_events, reduce_host_ms = [], [], []
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
        t = time.perf_counter()
        out = reduce_tree(*a)
        reduce_host_ms.append((time.perf_counter() - t) * 1e3)
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
    if len(reduce_events) != rounds:
        raise AssertionError(f"{name}: {len(reduce_events)} tree reduces "
                             f"timed, want one a round")
    reduce_ms = [a.elapsed_time(b) for a, b in reduce_events]
    want_k = [min(max(math.ceil(fed.k0 / r ** (1.0 / 3.0)), fed.k_min),
                  fed.k0) for r in range(1, rounds + 1)]
    if h.k != want_k:
        raise AssertionError(f"{name}: K {h.k} != {want_k}")
    if not all(math.isfinite(v) for v in h.train_loss + h.val_error):
        raise AssertionError(f"{name}: non-finite loss {h.train_loss}")
    want = rounds * math.ceil(leaves / fr.MAX_LEAVES)
    if launches != want:
        raise AssertionError(f"{name}: {launches} kernel launches, want "
                             f"{want}: one a round for {leaves} leaves")
    for i in range(rounds):
        emit({"phase": "main", "task": name, "round": h.rounds[i],
              "k": h.k[i], "loss": h.train_loss[i], "ms": round_ms[i],
              "reduce_ms": reduce_ms[i], "reduce_host_ms": reduce_host_ms[i],
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


# ---------------------------------------------------------------------------
# the dense LM serving path (phase 7)
# ---------------------------------------------------------------------------

# tests/test_kernels.py:12
FLASH_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# bf16 rows, besides FLASH_TOL against the plain version: every output row
# against the plain version run in f32 on the same inputs, within rtol x
# |want| + row_atol x the row's RMS (the wgmma kernel rounds P and the
# output to bf16, 2^-9 relative each), so a row is held to its own scale
FLASH_BF16_ROW_TOL = dict(rtol=2 ** -7, row_atol=2 ** -6)
# q and k of this stddev: the scaled scores q.k / sqrt(hd) have stddev
# ~2.6 and span several units, so the softmax is far from uniform, the
# running max moves between key tiles (the kernels must rescale O and l)
# and a softcap of 5 bends the largest scores
FLASH_QK_STD = 1.6
# (label, B, H, KV, Sq, Sk, hd, dtype, causal, window, softcap); the first
# row is the full-width prefill's shape (qwen1.5-0.5b, B 2, S 4096)
FLASH_SHAPES = [
    ("prefill", 2, 16, 16, 4096, 4096, 64, "float32", True, None, None),
    ("gqa", 1, 8, 2, 300, 300, 64, "float32", True, None, None),
    ("window64", 1, 8, 2, 300, 300, 64, "float32", True, 64, None),
    ("softcap5", 1, 8, 2, 300, 300, 64, "float32", True, None, 5.0),
    ("hd128", 1, 4, 2, 512, 512, 128, "float32", True, None, None),
    ("hd32", 2, 4, 4, 256, 256, 32, "float32", True, None, None),
    ("noncausal", 1, 8, 2, 300, 300, 64, "float32", False, None, None),
    ("bf16", 2, 16, 16, 4096, 4096, 64, "bfloat16", True, None, None),
    ("sq1", 2, 16, 16, 1, 257, 64, "float32", True, None, None),
    # head dims 112 (zamba2-7b's shared block at full width, B 2 x S 4096)
    # and 192 (nemotron-4-340b: 96 heads, GQA kv 8, S 2048)
    ("zamba2.hd112", 2, 32, 32, 4096, 4096, 112, "float32", True, None,
     None),
    ("zamba2.hd112.bf16", 2, 32, 32, 4096, 4096, 112, "bfloat16", True,
     None, None),
    ("nemotron.hd192", 1, 96, 8, 2048, 2048, 192, "float32", True, None,
     None),
    ("nemotron.hd192.bf16", 1, 96, 8, 2048, 2048, 192, "bfloat16", True,
     None, None),
    # the edge cases in bf16 (the tensor-core kernel), a ragged MHA tile,
    # hd 16 with a window, and phi3.5-moe's attention at its prefill shape
    ("gqa.bf16", 1, 8, 2, 300, 300, 64, "bfloat16", True, None, None),
    ("window64.bf16", 1, 8, 2, 300, 300, 64, "bfloat16", True, 64, None),
    ("softcap5.bf16", 1, 8, 2, 300, 300, 64, "bfloat16", True, None, 5.0),
    ("hd128.bf16", 1, 4, 2, 512, 512, 128, "bfloat16", True, None, None),
    ("hd32.bf16", 2, 4, 4, 256, 256, 32, "bfloat16", True, None, None),
    ("noncausal.bf16", 1, 8, 2, 300, 300, 64, "bfloat16", False, None,
     None),
    ("sq1.bf16", 2, 16, 16, 1, 257, 64, "bfloat16", True, None, None),
    ("ragged300.bf16", 1, 4, 4, 300, 300, 64, "bfloat16", True, None, None),
    ("hd16.bf16", 1, 2, 1, 80, 80, 16, "bfloat16", True, 16, None),
    ("phi3.5-moe.bf16", 2, 32, 8, 4096, 4096, 128, "bfloat16", True, None,
     None),
]
LM_ARCH = "qwen1.5-0.5b"
LM_PARAMS = 463_987_712
LM_BATCH, LM_SEQ = 2, 4096            # train_4k's sequence length
PARITY_ARCHS = ("qwen1.5-0.5b-reduced", "gemma2-27b-reduced",
                "phi3.5-moe-42b-a6.6b-reduced", "mixtral-8x22b-reduced")
PARITY_TOL = dict(rtol=2e-4, atol=2e-4)
SERVE = dict(batch=4, prompt_len=16, tokens=32)   # launch/serve.py defaults


def attended_pairs(torch, sq, sk, causal, window) -> int:
    """(query, key) pairs the mask lets through, counted from the mask."""
    qi = torch.arange(sq)[:, None]
    kj = torch.arange(sk)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        m &= kj <= qi
    if window is not None:
        m &= kj > qi - window
    return int(m.sum())


def launched_path(mod, call) -> str:
    """The one path (``mod.PATHS``) whose launch count ``call()`` raised."""
    before = dict(mod.launches_by_path)
    call()
    moved = [p for p in mod.PATHS if mod.launches_by_path[p] != before[p]]
    if len(moved) != 1 or mod.launches_by_path[moved[0]] != \
            before[moved[0]] + 1:
        raise AssertionError(f"one launch on one path expected: "
                             f"{before} -> {mod.launches_by_path}")
    return moved[0]


def flash_row_err(torch, got, q, k, v, kw) -> float:
    """The bf16 output ``got`` against the plain version run in f32 on the
    same inputs, row by row: the largest |error| over its bound under
    ``FLASH_BF16_ROW_TOL`` (at most 1 passes)."""
    from repro_torch.kernels.ref import flash_attention_ref
    want = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    rms = want.square().mean(-1, keepdim=True).sqrt()
    bound = (FLASH_BF16_ROW_TOL["rtol"] * want.abs()
             + FLASH_BF16_ROW_TOL["row_atol"] * rms)
    return float(((got.float() - want).abs() / bound).max())


def phase_flash_kernel(torch, bw: float, f32_peak: float, bf16_peak: float):
    """``flash_attention`` against its plain version at ``FLASH_SHAPES``
    (bf16 also row by row against the plain version in f32), with device
    times of the kernel, the plain version and
    ``F.scaled_dot_product_attention`` (the library call, where one computes
    the same function; none for the softcap)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(256 * 2 ** 20 // 4, device="cuda")
    rows = []
    for (label, B, H, KV, sq, sk, hd, dt, causal, window,
         softcap) in FLASH_SHAPES:
        dtype = getattr(torch, dt)
        q = (torch.randn((B, H, sq, hd), generator=gen, device="cuda")
             * FLASH_QK_STD).to(dtype)
        k = (torch.randn((B, KV, sk, hd), generator=gen, device="cuda")
             * FLASH_QK_STD).to(dtype)
        v = torch.randn((B, KV, sk, hd), generator=gen,
                        device="cuda").to(dtype)
        kw = dict(causal=causal, window=window, softcap=softcap)
        path = launched_path(fa, lambda: fa.flash_attention(q, k, v, **kw))
        if path != fa.kernel_path(hd, dtype) or \
                path != ("wgmma" if dt == "bfloat16" else "wgmma_split"):
            raise AssertionError(f"flash {label}: launched {path}")
        got = fa.flash_attention(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash {label}: not repeatable")
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[dt])
        err = float((got.float() - want.float()).abs().max())
        extra = {}
        if dt == "bfloat16":
            extra["row_err_over_tol"] = flash_row_err(torch, got, q, k, v,
                                                      kw)
            if not extra["row_err_over_tol"] <= 1.0:
                raise AssertionError(
                    f"flash {label}: rows off by "
                    f"{extra['row_err_over_tol']} x {FLASH_BF16_ROW_TOL} "
                    f"of the plain version in f32")
        del got, again, want
        lib = None
        if softcap is None:
            from repro_torch.kernels.ref import attention_mask
            mask = (None if window is None and sq == sk
                    else attention_mask(sq, sk, causal, window, "cuda"))
            lkw = (dict(attn_mask=mask) if mask is not None
                   else dict(is_causal=causal))
            lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=H != KV, **lkw), flush)
        pairs = attended_pairs(torch, sq, sk, causal, window)
        es = q.element_size()
        nbytes = es * (2 * q.numel() + k.numel() + v.numel())
        rows.append(_row(
            "flash_attention", label,
            {"b": B, "h": H, "kv": KV, "sq": sq, "sk": sk, "hd": hd,
             "dtype": dt, "path": path, **extra,
             **{key: val for key, val in kw.items() if val is not None}},
            err, FLASH_TOL[dt],
            time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw), flush),
            time_ms(torch, lambda: flash_attention_ref(q, k, v, **kw), flush),
            lib, nbytes, 4 * B * H * hd * pairs, bw,
            path_peak(path, f32_peak, bf16_peak)))
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def _lm_tokens(cfg, b, s, seed):
    import numpy as np
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


class RouteLog:
    """Instrumentation of this script only: wraps ``models.moe._route`` and
    keeps, for each call (one MoE layer), the routing ids and each token's
    smallest margin between neighbouring probabilities of its top k + 1,
    on the device (no synchronisation).

    With ``force`` (the log of another run) each layer takes that run's
    ids, weighted by this run's own probabilities as ``_route`` weights
    them, so one flipped choice cannot cascade through the later layers;
    the own ids are still logged for ``route_flips``. Where the ids agree
    the forced result is bit for bit the unforced one."""

    def __init__(self, torch, force=None):
        from repro_torch.models import moe
        self.torch, self.mod, self.route, self.calls = torch, moe, \
            moe._route, []
        self.force = force

    def __enter__(self):
        torch = self.torch

        def recording(p, cfg, xf):
            w, ids, aux = self.route(p, cfg, xf)
            probs = torch.softmax((xf @ p["router"]["kernel"]).float(), -1)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
            self.calls.append((ids, (top[:, :-1] - top[:, 1:]).amin(-1)))
            if self.force is None:
                return w, ids, aux
            ids = self.force.calls[len(self.calls) - 1][0]
            w = torch.gather(probs, -1, ids)
            w = w / torch.sum(w, dim=-1, keepdim=True)
            E = cfg.moe.num_experts
            f_e = torch.mean(self.mod._one_hot(ids[:, 0], E), dim=0)
            aux = E * torch.sum(f_e * torch.mean(probs, dim=0))
            return w.to(xf.dtype), ids, aux
        self.mod._route = recording
        return self

    def __exit__(self, *exc):
        self.mod._route = self.route


# routing probabilities closer than this may order differently on two
# devices or paths: 2 x (atol + rtol x 1) of PARITY_TOL, probabilities <= 1
ROUTE_TOL = 2 * (PARITY_TOL["atol"] + PARITY_TOL["rtol"])


def route_flips(torch, a: RouteLog, b: RouteLog, layers: int,
                tol: float = ROUTE_TOL):
    """Compare two runs' own routing ids, layer by layer: {flipped (token,
    layer) choices, their count per layer, the smallest margin among them,
    the smallest margin of all}. Raises where ids differ though the margin
    exceeds ``tol``."""
    if len(a.calls) != layers or len(b.calls) != layers:
        raise AssertionError(f"{len(a.calls)} / {len(b.calls)} routed "
                             f"layers, want {layers}")
    per_layer, flip_margin, smallest, bad = [], math.inf, math.inf, []
    for layer, ((ia, ma), (ib, mb)) in enumerate(zip(a.calls, b.calls)):
        margin = torch.minimum(ma.cpu(), mb.cpu())
        diff = (ia.cpu() != ib.cpu()).any(-1)
        per_layer.append(int(diff.sum()))
        if bool(diff.any()):
            flip_margin = min(flip_margin, float(margin[diff].min()))
            wide = diff & (margin > tol)
            if bool(wide.any()):
                bad.append((layer, int(wide.sum()),
                            float(margin[wide].max())))
        smallest = min(smallest, float(margin.min()))
    out = {"route_flips": sum(per_layer), "route_flips_per_layer": per_layer,
           "route_flip_min_margin": (flip_margin if sum(per_layer)
                                     else None),
           "min_route_margin": smallest, "route_tol": tol}
    if bad:
        raise AssertionError(f"routing differs where the margin exceeds "
                             f"{tol}: (layer, tokens, largest margin) "
                             f"{bad}; {out}")
    return out


def phase_parity_lm(torch, names=PARITY_ARCHS):
    """Reduced configs (``PARITY_ARCHS``: qwen1.5-0.5b, gemma2-27b,
    phi3.5-moe-42b-a6.6b, mixtral-8x22b; ``SSM_PARITY``): prefill through
    the kernels on the card against the plain path on the CPU (last-token
    logits, the decode states (KV, or SSM and conv) and, for MoE, every
    layer's routing ids), then 8 greedy decode steps on both (MoE on the
    serving loop's dense path), each fed the CPU's token: the card's argmax
    must equal the CPU's wherever the CPU's top-2 logit gap exceeds the
    tolerance."""
    from repro_torch.distributed import make_prefill_step
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves, tree_map
    for name in names:
        cfg = lm_config(name)
        cpu = registry.init(0, cfg, device="cpu")
        card = tree_map(lambda t: t.to("cuda"), cpu)
        toks = torch.tensor(_lm_tokens(cfg, 2, 96, 5))
        with torch.no_grad(), RouteLog(torch) as rcpu:
            want, wst = make_prefill_step(cfg, use_kernel=False)(
                cpu, {"tokens": toks})
        with torch.no_grad(), RouteLog(torch) as rcard:
            got, gst = make_prefill_step(cfg, use_kernel=True)(
                card, {"tokens": toks.cuda()})
        routing = {}
        if cfg.moe is not None:
            routing = route_flips(torch, rcpu, rcard, cfg.num_layers)
        torch.testing.assert_close(got.cpu(), want, **PARITY_TOL)
        st_err = 0.0
        for a, b in zip(tree_leaves(wst), tree_leaves(gst)):
            torch.testing.assert_close(b.cpu(), a, **PARITY_TOL)
            st_err = max(st_err, float((b.cpu() - a).abs().max()))
        step = registry.decode_fn(cfg, moe_path="dense")
        n_prompt, n_new = 16, 8
        steps = n_prompt + n_new - 1
        caches = {"cpu": registry.init_cache(cpu, cfg, 2, steps),
                  "cuda": registry.init_cache(card, cfg, 2, steps)}
        params = {"cpu": cpu, "cuda": card}
        prompt = torch.tensor(_lm_tokens(cfg, 2, n_prompt, 6))
        ids, gaps, worst = [], [], 0.0
        tok = None
        with torch.no_grad():
            for pos in range(steps):
                fed = prompt[:, pos] if pos < n_prompt else tok
                logits = {dev: step(params[dev], caches[dev], fed.to(dev),
                                    pos)[0].cpu() for dev in params}
                worst = max(worst, float((logits["cuda"]
                                          - logits["cpu"]).abs().max()))
                if pos < n_prompt - 1:
                    continue
                top2 = torch.topk(logits["cpu"], 2, dim=-1).values
                gap = top2[:, 0] - top2[:, 1]
                tok = torch.argmax(logits["cpu"], dim=-1)
                card_tok = torch.argmax(logits["cuda"], dim=-1)
                tol = 2 * (PARITY_TOL["atol"] + PARITY_TOL["rtol"]
                           * float(logits["cpu"].abs().max()))
                bad = (card_tok != tok) & (gap > tol)
                if bool(bad.any()):
                    raise AssertionError(f"{name} decode step {pos}: card "
                                         f"{card_tok.tolist()} vs cpu "
                                         f"{tok.tolist()}, gaps "
                                         f"{gap.tolist()}")
                ids.append(tok.tolist())
                gaps.append(float(gap.min()))
        emit({"phase": "parity", "what": f"{name}: prefill (kernel, cuda) "
              f"vs plain (cpu), 8 greedy decode tokens",
              "logits_max_abs_err": float((got.cpu() - want).abs().max()),
              "states_max_abs_err": st_err, "tol": PARITY_TOL,
              "greedy_ids": [list(r) for r in zip(*ids)][:2],
              "decode_logit_max_abs_err": worst,
              "min_top2_gap": min(gaps), **routing})


FLASH = ("flash_attention", "flash", "attn")
SSD = ("ssd_scan", "ssd", "mamba")
# the path of every launch in an f32 prefill, by kernel module
F32_PREFILL_PATHS = {"flash_attention": "wgmma_split",
                     "moe_gmm": "wgmma_split", "ssd_scan": "fma"}


def f32_prefill_paths(mods, per_prefill):
    """Each module's launches by path over four f32 prefills, checked:
    ``per_prefill[name]`` launches a prefill, all on the module's
    ``F32_PREFILL_PATHS`` path. Returns them a prefill."""
    out = {}
    for name, mod in mods.items():
        got = dict(mod.launches_by_path)
        want = {p: 4 * per_prefill[name] if p == F32_PREFILL_PATHS[name]
                else 0 for p in mod.PATHS}
        if got != want:
            raise AssertionError(f"{name} launches by path in 4 f32 "
                                 f"prefills {got}, want {want}")
        out[name] = {p: n // 4 for p, n in got.items()}
    return out


def layer_count(cfg, ltype: str) -> int:
    """Layers of type ``ltype`` in ``cfg``'s stack (a hybrid's ``attn``
    positions all run the one shared block)."""
    from repro_torch.models.transformer import cycle_spec
    spec = cycle_spec(cfg)
    return sum(spec[i % len(spec)] == ltype for i in range(cfg.num_layers))


def reset_counts(mod) -> None:
    """Zero a kernel module's launch counts (total and, where the module
    has two kernels, by path)."""
    mod.launches = 0
    if hasattr(mod, "launches_by_path"):
        mod.launches_by_path = dict.fromkeys(mod.PATHS, 0)


def timed_prefills(torch, step, params, batch, kernels, runs: int = 3):
    """One warm-up and ``runs`` timed calls of ``step(params, batch)``, the
    kernels' launch counts zeroed first. Instrumentation of this script
    only: the host clock between synchronisations around each call, CUDA
    events around each call of the kernels' wrappers (``kernels``: {short
    name: (module, wrapper name)}), and a ``RouteLog`` of the warm-up (MoE
    routing ids). Returns the last (logits, states), the times in ms, each
    kernel's median share of a prefill and the warm-up's ``RouteLog``."""
    events = {key: [] for key in kernels}
    saved = {key: getattr(mod, fn) for key, (mod, fn) in kernels.items()}

    def timed(key):
        def call(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = saved[key](*a, **kw)
            ev[1].record()
            events[key].append(ev)
            return out
        return call

    for key, (mod, fn) in kernels.items():
        reset_counts(mod)
        setattr(mod, fn, timed(key))
    try:
        with RouteLog(torch) as routes:
            out, _ = run_step(torch, step, params, batch)
        times, shares = [], {key: [] for key in kernels}
        for _ in range(runs):
            for evs in events.values():
                evs.clear()
            out, ms = run_step(torch, step, params, batch)
            times.append(ms)
            for key, evs in events.items():
                shares[key].append(
                    sum(a.elapsed_time(b) for a, b in evs) / ms)
    finally:
        for key, (mod, fn) in kernels.items():
            setattr(mod, fn, saved[key])
    return out, times, {key: statistics.median(v)
                        for key, v in shares.items()}, routes


def run_step(torch, step, params, batch):
    """``step(params, batch)`` without autograd, and its ms on the host
    clock between synchronisations."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.no_grad():
        out = step(params, batch)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def phase_lm(torch, phase="lm", arch=LM_ARCH, n_want=LM_PARAMS,
             kernels=(FLASH,), seed=7, state_tol=PARITY_TOL, extra=None):
    """One architecture at full width (``arch``, ``n_want`` params): prefill
    B 2 x S 4096 through its kernels (each ``(module, short name, layer
    type)``: the wrapper of that name in ``repro_torch.kernels``, one launch
    a layer of that type; the short name names its share), the plain path
    on the same batch (logits within 1e-3, decode states within
    ``state_tol``), then ``ServingLoop`` greedy decode. ``extra(cfg)`` adds
    config fields to the prefill line. Phase ``lm``: qwen1.5-0.5b through
    ``flash_attention``; phase ``ssm``: mamba2-780m through ``ssd_scan``;
    phase ``zamba2``: zamba2-7b through both. Returns {module: launches}
    counted over the four kernel prefills, and the f32 params."""
    import importlib
    from repro_torch.configs import get_arch
    from repro_torch.core.engine.model_store import GlobalModelStore
    from repro_torch.core.serve import ServingLoop
    from repro_torch.distributed import make_prefill_step
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves
    mods = {k[0]: importlib.import_module(f"repro_torch.kernels.{k[0]}")
            for k in kernels}
    cfg = get_arch(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init(torch.Generator().manual_seed(0), cfg,
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != n_want or registry.param_count(cfg) != n_want:
        raise AssertionError(f"{arch}: {n_params} params, want {n_want}")
    batch = {"tokens": torch.tensor(_lm_tokens(cfg, LM_BATCH, LM_SEQ, seed),
                                    device="cuda")}

    (logits, states), times, shares, _ = timed_prefills(
        torch, make_prefill_step(cfg, use_kernel=True), params, batch,
        {name: (mod, name) for name, mod in mods.items()})
    launches = {name: mod.launches for name, mod in mods.items()}
    for name, _, ltype in kernels:
        if launches[name] != 4 * layer_count(cfg, ltype):
            raise AssertionError(
                f"{launches[name]} {name} launches in 4 prefills, want "
                f"{4 * layer_count(cfg, ltype)}")
    by_path = f32_prefill_paths(
        mods, {name: layer_count(cfg, ltype) for name, _, ltype in kernels})
    if logits.shape != (LM_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} or "
                             f"not finite")
    (plain_logits, plain_states), plain_ms = run_step(
        torch, make_prefill_step(cfg, use_kernel=False), params, batch)
    if {name: mod.launches for name, mod in mods.items()} != launches:
        raise AssertionError("the plain prefill launched a kernel")
    torch.testing.assert_close(logits, plain_logits, rtol=1e-3, atol=1e-3)
    st_err = {}                      # by state name: k, v or ssm, conv
    for (path, st), (_, plain) in zip(leaf_items(states, ""),
                                      leaf_items(plain_states, "")):
        torch.testing.assert_close(st, plain, **state_tol)
        key = path.rsplit(".", 1)[-1]
        st_err[key] = max(st_err.get(key, 0.0),
                          float((st - plain).abs().max()))
    order = sorted(times)
    emit({"phase": phase, "what": "prefill", "arch": arch,
          **(extra(cfg) if extra else {}),
          "params": n_params, "dtype": "float32", "batch": LM_BATCH,
          "seq": LM_SEQ, "init_s": init_s,
          "ms": order[len(order) // 2], "ms_runs": times,
          **{f"{short}_share": shares[name] for name, short, _ in kernels},
          **{f"{short}_launches_per_prefill": launches[name] // 4
             for name, short, _ in kernels},
          **{f"{short}_launches_per_prefill_by_path": by_path[name]
             for name, short, _ in kernels},
          "plain_ms": plain_ms,
          "logits_max_abs_err_vs_plain": float(
              (logits - plain_logits).abs().max()),
          "states_max_abs_err_vs_plain": max(st_err.values()),
          "states_max_abs_err_by_key": st_err, "states_tol": state_tol,
          "logits_argmax": torch.argmax(logits, -1).tolist()})
    del states, plain_states, logits, plain_logits

    loop = ServingLoop(GlobalModelStore(params=params), cfg, **SERVE)
    runs = [loop.decode(loop._traffic(t)) for t in range(2)]
    ids, dt = runs[-1]
    n_tok = SERVE["batch"] * SERVE["tokens"]
    if ids.shape != (SERVE["batch"], SERVE["tokens"]):
        raise AssertionError(f"decode ids {tuple(ids.shape)}")
    emit({"phase": phase, "what": "serve", "arch": arch, **SERVE,
          "tokens_per_s": n_tok / dt, "first_tokens_per_s": n_tok / runs[0][1],
          "ms_per_step": dt / SERVE["tokens"] * 1e3,
          "ids": ids.tolist(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, params


# the bf16 prefills (phases lm and moe). The bf16 model is the phase's f32
# model cast to bf16 on the card: registry.init draws every weight in f32
# and casts it (layers.normal_init), so this is registry.init(0, cfg,
# dtype=torch.bfloat16) without drawing again (tests/test_torch_bf16.py
# checks the equality). The kernel path and the plain bf16 path both round
# to bf16, at other points (flash's P, the order of each sum), so neither
# is the exact answer. The anchor is the plain path in f32 on the same
# bf16-valued weights (the f32 model rounded in place) and the kernel run's
# routing ids. For the logits and every state leaf, the kernel path's
# relative distance to the anchor (Frobenius) must be at most
# BF16_ANCHOR_FACTOR x the plain bf16 path's: the kernels may cost no more
# accuracy than computing in bf16 does. The plain path's own distance must
# stay under BF16_PLAIN_MAX, far below the ~1.4 of an anchor on other
# weights or tokens. Routing choices closer than two bf16 tolerances may
# flip between the kernel and plain paths.
BF16_ANCHOR_FACTOR = 2.0
BF16_PLAIN_MAX = 0.25
BF16_ROUTE_TOL = 2 * (FLASH_TOL["bfloat16"]["atol"]
                      + FLASH_TOL["bfloat16"]["rtol"])


def rel_dist(torch, x, anchor) -> float:
    """||x - anchor|| / ||anchor|| over the whole tensor, in f32."""
    x, anchor = x.float(), anchor.float()
    return float(torch.linalg.vector_norm(x - anchor)
                 / torch.linalg.vector_norm(anchor))


def phase_bf16_prefill(torch, phase, cfg, params, kernels, seed):
    """``cfg`` at full width in bf16: the phase's f32 ``params`` cast to
    bf16 on the card, then rounded in place to those bf16 values (the
    anchor's weights). Prefill B 2 x S 4096 through the kernels
    (``kernels``: {short name: (module, wrapper name, launches a
    prefill)}), every launch on the ``"wgmma"`` path, then the plain bf16
    path on the same batch and, the bf16 model freed, the plain f32 path on
    the rounded weights (both with the kernel run's routing ids). Returns
    {short name: launches} over the four kernel prefills."""
    from repro_torch.distributed import make_prefill_step
    from repro_torch.optim import tree_leaves, tree_map
    if {t.dtype for t in tree_leaves(params)} != {torch.float32}:
        raise AssertionError("the bf16 prefill casts an f32 model")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bf16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    for t, b in zip(tree_leaves(params), tree_leaves(bf16)):
        t.copy_(b)
    torch.cuda.synchronize()
    cast_s = time.perf_counter() - t0
    batch = {"tokens": torch.tensor(_lm_tokens(cfg, LM_BATCH, LM_SEQ, seed),
                                    device="cuda")}
    (logits, states), times, shares, kroutes = timed_prefills(
        torch, make_prefill_step(cfg, use_kernel=True), bf16, batch,
        {key: (mod, fn) for key, (mod, fn, _) in kernels.items()})
    launches = {key: mod.launches for key, (mod, _, _) in kernels.items()}
    by_path = {key: dict(mod.launches_by_path)
               for key, (mod, _, _) in kernels.items()}
    for key, (_, _, per) in kernels.items():
        if by_path[key] != {p: 4 * per if p == "wgmma" else 0
                            for p in by_path[key]}:
            raise AssertionError(f"{key} launches by path in 4 bf16 "
                                 f"prefills {by_path[key]}, want "
                                 f"{4 * per} on wgmma")
    if logits.shape != (LM_BATCH, cfg.vocab_size) or \
            logits.dtype != torch.bfloat16 or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bf16 prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype} or not finite")
    with RouteLog(torch, force=kroutes) as proutes:
        (plain_logits, plain_states), plain_ms = run_step(
            torch, make_prefill_step(cfg, use_kernel=False), bf16, batch)
    n_params = sum(t.numel() for t in tree_leaves(bf16))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del bf16
    torch.cuda.empty_cache()
    with RouteLog(torch, force=kroutes):
        (anchor_logits, anchor_states), _ = run_step(
            torch, make_prefill_step(cfg, use_kernel=False), params, batch)
    if {key: mod.launches for key, (mod, _, _) in kernels.items()} \
            != launches:
        raise AssertionError("a plain prefill launched a kernel")
    routing = (route_flips(torch, kroutes, proutes, cfg.num_layers,
                           BF16_ROUTE_TOL) if cfg.moe is not None else {})
    outs = [("logits", logits, plain_logits, anchor_logits)] + [
        (path, a, b, c) for (path, a), (_, b), (_, c) in zip(
            leaf_items(states, "states"), leaf_items(plain_states, ""),
            leaf_items(anchor_states, ""))]
    dist = {key: (rel_dist(torch, got, anchor), rel_dist(torch, plain, anchor))
            for key, got, plain, anchor in outs}
    bad = {key: d for key, d in dist.items()
           if not (d[0] <= BF16_ANCHOR_FACTOR * d[1]
                   and d[1] <= BF16_PLAIN_MAX)}
    if bad:
        raise AssertionError(f"bf16 prefill: (kernel, plain) distances to "
                             f"the f32 anchor {bad} break the rule "
                             f"kernel <= {BF16_ANCHOR_FACTOR} x plain <= "
                             f"{BF16_ANCHOR_FACTOR * BF16_PLAIN_MAX}")
    states_dist = [d for key, d in dist.items() if key != "logits"]
    order = sorted(times)
    emit({"phase": phase, "what": "prefill", "arch": cfg.name,
          "layers": cfg.num_layers, "dtype": "bfloat16", "params": n_params,
          "weights": "the phase's f32 model cast to bf16 on the card",
          "batch": LM_BATCH, "seq": LM_SEQ, "cast_s": cast_s,
          "ms": order[len(order) // 2], "ms_runs": times,
          **{f"{key}_share": shares[key] for key in kernels},
          **{f"{key}_launches_per_prefill_by_path":
             {p: n // 4 for p, n in by_path[key].items()}
             for key in kernels},
          "plain_ms": plain_ms,
          "logits_rel_dist_to_f32": dict(zip(("kernel", "plain"),
                                             dist["logits"])),
          "states_rel_dist_to_f32_max": {
              "kernel": max(d[0] for d in states_dist),
              "plain": max(d[1] for d in states_dist)},
          "kernel_over_plain_max": max(d[0] / max(d[1], 1e-30)
                                        for d in dist.values()),
          "rule": {"anchor_factor": BF16_ANCHOR_FACTOR,
                   "plain_max": BF16_PLAIN_MAX},
          "logits_max_abs_err_vs_plain": float(
              (logits.float() - plain_logits.float()).abs().max()),
          "logits_max_abs": float(anchor_logits.abs().max()),
          "logits_argmax_equal_plain": bool(torch.equal(
              logits.argmax(-1), plain_logits.argmax(-1))),
          **routing, "logits_argmax": torch.argmax(logits, -1).tolist(),
          "peak_mem_gb": peak_gb,
          "f32_weights_gb_in_peak": 4 * n_params / 1e9})
    return launches


# ---------------------------------------------------------------------------
# the MoE serving path (phase 8)
# ---------------------------------------------------------------------------

# tests/test_kernels.py:12-14
GMM_TOL = FLASH_TOL
# (label, E, C, d, f): the full-width prefill's gate/up and down shapes
# first (phi3.5-moe, B 2 x S 4096, top-2 of 16 experts: capacity 1280),
# then the reference sweep (tests/test_kernels.py:138-139) and the
# decode-dispatch floor C = 8
GMM_SHAPES = [("gate_up", 16, 1280, 4096, 6400),
              ("down", 16, 1280, 6400, 4096),
              ("sweep", 4, 128, 256, 512),
              ("sweep", 8, 100, 512, 384),
              ("sweep", 2, 257, 320, 640),
              ("decode_c8", 16, 8, 4096, 6400),
              # widths no multiple of 8: the FMA kernel, in both dtypes
              ("unaligned", 2, 100, 252, 260)]
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
# 8 of its 32 layers: all 32 hold 168 GB in f32, past the card's 80 GB
MOE_LAYERS = 8
MOE_BATCH, MOE_SEQ = 2, 4096


def phase_gmm_kernel(torch, bw: float, f32_peak: float, bf16_peak: float):
    """``gmm`` against its plain version at ``GMM_SHAPES`` in f32 and bf16,
    with device times of the kernel, the plain version and ``torch.bmm``
    (the library call computing the same product); inputs at the model's
    scales (unit activations, weights of stddev d^-0.5)."""
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels.ref import gmm_ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(256 * 2 ** 20 // 4, device="cuda")
    rows = []
    for label, E, C, d, f in GMM_SHAPES:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            x = torch.randn((E, C, d), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((E, d, f), generator=gen, device="cuda")
                 / math.sqrt(d)).to(dtype)
            path = launched_path(mg, lambda: mg.gmm(x, w))
            want_path = ("fma" if d % 8 or f % 8 else
                         "wgmma" if dt == "bfloat16" else "wgmma_split")
            if path != mg.kernel_path(E, C, d, f, dtype) or \
                    path != want_path:
                raise AssertionError(f"gmm {label} {dt}: launched {path}")
            got = mg.gmm(x, w)
            again = mg.gmm(x, w)
            want = gmm_ref(x, w)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"gmm {label} {dt}: not repeatable")
            torch.testing.assert_close(got.float(), want.float(),
                                       **GMM_TOL[dt])
            err = float((got.float() - want.float()).abs().max())
            del got, again, want
            es = x.element_size()
            rows.append(_row(
                "gmm", label, {"e": E, "c": C, "d": d, "f": f, "dtype": dt,
                               "path": path},
                err, GMM_TOL[dt],
                time_ms(torch, lambda: mg.gmm(x, w), flush),
                time_ms(torch, lambda: gmm_ref(x, w), flush),
                time_ms(torch, lambda: torch.bmm(x, w), flush),
                es * (E * C * d + E * d * f + E * C * f), 2 * E * C * d * f,
                bw, path_peak(path, f32_peak, bf16_peak)))
            del x, w
    del flush
    torch.cuda.empty_cache()
    return rows


def phase_moe(torch):
    """phi3.5-moe-42b-a6.6b at full width, ``MOE_LAYERS`` deep: prefill
    through the kernels, the plain path on the same batch, then
    ``ServingLoop`` greedy decode on the dense MoE path. Returns the
    kernel launches (gmm, flash) counted over the four kernel prefills, and
    the f32 params."""
    from repro_torch.configs import get_arch
    from repro_torch.core.engine.model_store import GlobalModelStore
    from repro_torch.core.serve import ServingLoop
    from repro_torch.distributed import make_prefill_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves
    cfg = dataclasses.replace(get_arch(MOE_ARCH), num_layers=MOE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init(torch.Generator().manual_seed(0), cfg,
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != registry.param_count(cfg):
        raise AssertionError(f"{n_params} params, want "
                             f"{registry.param_count(cfg)}")
    batch = {"tokens": torch.tensor(_lm_tokens(cfg, MOE_BATCH, MOE_SEQ, 8),
                                    device="cuda")}

    (logits, states), times, shares, kroutes = timed_prefills(
        torch, make_prefill_step(cfg, use_kernel=True), params, batch,
        {"gmm": (mg, "gmm"), "flash": (fa, "flash_attention")})
    launches = {"gmm": mg.launches, "flash": fa.launches}
    want = {"gmm": 4 * 3 * cfg.num_layers, "flash": 4 * cfg.num_layers}
    if launches != want:
        raise AssertionError(f"launches in 4 prefills {launches}, want "
                             f"{want}")
    by_path = f32_prefill_paths(
        {"moe_gmm": mg, "flash_attention": fa},
        {"moe_gmm": 3 * cfg.num_layers, "flash_attention": cfg.num_layers})
    if logits.shape != (MOE_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} or "
                             f"not finite")
    # the plain path takes the kernel run's routing ids (RouteLog), so its
    # logits and states are held to the tolerance even where a choice with
    # a margin under ROUTE_TOL flips; the flips are counted from each run's
    # own ids
    with RouteLog(torch, force=kroutes) as proutes:
        (plain_logits, plain_states), plain_ms = run_step(
            torch, make_prefill_step(cfg, use_kernel=False), params, batch)
    if (mg.launches, fa.launches) != (want["gmm"], want["flash"]):
        raise AssertionError("the plain prefill launched a kernel")
    routing = route_flips(torch, kroutes, proutes, cfg.num_layers)
    torch.testing.assert_close(logits, plain_logits, rtol=1e-3, atol=1e-3)
    st_err = 0.0
    for a, b in zip(tree_leaves(states), tree_leaves(plain_states)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
        st_err = max(st_err, float((a - b).abs().max()))
    order = sorted(times)
    emit({"phase": "moe", "what": "prefill", "arch": MOE_ARCH,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
          "d_ff": cfg.d_ff, "params": n_params,
          "active_params": registry.active_param_count(cfg),
          "dtype": "float32", "batch": MOE_BATCH, "seq": MOE_SEQ,
          "init_s": init_s, "ms": order[len(order) // 2], "ms_runs": times,
          "gmm_share": shares["gmm"], "flash_share": shares["flash"],
          "gmm_launches_per_prefill": launches["gmm"] // 4,
          "flash_launches_per_prefill": launches["flash"] // 4,
          "gmm_launches_per_prefill_by_path": by_path["moe_gmm"],
          "flash_launches_per_prefill_by_path": by_path["flash_attention"],
          "plain_ms": plain_ms,
          "logits_max_abs_err_vs_plain": float(
              (logits - plain_logits).abs().max()),
          "states_max_abs_err_vs_plain": st_err, **routing,
          "logits_argmax": torch.argmax(logits, -1).tolist()})
    del states, plain_states, logits, plain_logits, kroutes, proutes

    loop = ServingLoop(GlobalModelStore(params=params), cfg, **SERVE)
    runs = [loop.decode(loop._traffic(t)) for t in range(2)]
    ids, dt = runs[-1]
    n_tok = SERVE["batch"] * SERVE["tokens"]
    if ids.shape != (SERVE["batch"], SERVE["tokens"]):
        raise AssertionError(f"decode ids {tuple(ids.shape)}")
    emit({"phase": "moe", "what": "serve", "arch": MOE_ARCH,
          "layers": cfg.num_layers, "moe_path": "dense", **SERVE,
          "tokens_per_s": n_tok / dt, "first_tokens_per_s": n_tok / runs[0][1],
          "ms_per_step": dt / SERVE["tokens"] * 1e3,
          "ids": ids.tolist(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, params


# ---------------------------------------------------------------------------
# the SSM serving path (phase 9)
# ---------------------------------------------------------------------------

# tests/test_kernels.py:104-107 (the cumsum and the sums run in another
# order); bf16 adds one bf16 ulp of the output
SSD_TOL = {"float32": dict(rtol=5e-4, atol=5e-4),
           "bfloat16": dict(rtol=2 ** -7, atol=5e-4)}
# (label, B, S, H, P, N, chunk, dtype): the full-width prefill's shape
# first (mamba2-780m, B 2, S 4096), then the reference sweep
# (tests/test_kernels.py:89-93), zamba2-7b's widths, the reduced configs'
# widths and chunk, a ragged S, S < chunk and bf16
SSD_SHAPES = [
    ("prefill", 2, 4096, 48, 64, 128, 256, "float32"),
    ("sweep", 1, 64, 2, 32, 16, 16, "float32"),
    ("sweep", 2, 96, 3, 64, 32, 32, "float32"),
    ("sweep", 1, 256, 1, 64, 128, 64, "float32"),
    ("zamba2", 1, 4096, 112, 64, 64, 256, "float32"),
    ("chunk32", 2, 4096, 8, 32, 16, 32, "float32"),
    ("ragged", 2, 4000, 48, 64, 128, 256, "float32"),
    ("short", 2, 100, 48, 64, 128, 256, "float32"),
    ("bf16", 2, 4096, 48, 64, 128, 256, "bfloat16"),
]
SSM_ARCH = "mamba2-780m"
SSM_PARAMS = 857_379_072
HYBRID = "zamba2-7b-reduced-hybrid5"
SSM_PARITY = ("mamba2-780m-reduced", "zamba2-7b-reduced", HYBRID)
# the plain path's decode states against the kernel path's, 48 layers deep
SSM_STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# phase zamba2: the hybrid at full width (81 layers: 68 mamba, 13 through
# the shared attention block at head_dim 112)
ZAMBA_ARCH = "zamba2-7b"
ZAMBA_PARAMS = 5_737_416_000


def lm_config(name: str):
    """The config of ``name``; ``HYBRID`` is reduced zamba2-7b with the
    pattern (mamba, attn) over 5 layers: 2 cycles through the shared
    attention block and a mamba tail (reduced zamba2 keeps only its first
    two layer types, both mamba)."""
    from repro_torch.configs import get_arch
    if name != HYBRID:
        return get_arch(name)
    return dataclasses.replace(get_arch("zamba2-7b-reduced"), name=HYBRID,
                               layer_pattern=("mamba", "attn"), num_layers=5)


def ssd_work(B, S, H, P, N, Q):
    """(flops, bytes) the scan needs at these shapes, x/b/c/y in 4-byte
    elements. Flops: C.B^T once per batch and chunk over the causal pairs
    (heads share it), and per head the gate (3 a pair), gate.x over the
    pairs, the chunk states and the inter-chunk term C.S_prev (Q N P
    each, for every chunk after the first), the state recurrence and the
    D skip; steps past S count nothing. Bytes: x, dt, b, c, A, D read once,
    y and the final state written once."""
    flops, pairs = 0, 0
    for s0 in range(0, S, Q):
        q = min(Q, S - s0)
        pairs = q * (q + 1) // 2
        flops += B * (2 * pairs * N + H * (3 * pairs + 2 * pairs * P
                                           + 2 * q * N * P + 2 * N * P))
        if s0:
            flops += B * H * 2 * q * N * P
    flops += B * S * H * P * 2
    nbytes = 4 * (2 * B * S * H * P + B * S * H + 2 * B * S * N + 2 * H
                  + B * H * N * P)
    return flops, nbytes


def ssd_inputs(torch, gen, B, S, H, P, N, dtype):
    """The reference kernel test's distributions (tests/test_kernels.py:
    95-100): unit x, softplus(unit) dt, A = -exp(0.3 unit), b/c at 0.5."""
    dev = "cuda"
    x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=dev))
    A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.3)
    b = (torch.randn((B, S, N), generator=gen, device=dev) * 0.5).to(dtype)
    c = (torch.randn((B, S, N), generator=gen, device=dev) * 0.5).to(dtype)
    D = torch.linspace(0.5, 1.5, H, device=dev)
    return x, dt, A, b, c, D


def phase_ssd_kernel(torch, bw: float, f32_peak: float, bf16_peak: float):
    """``ssd_scan`` against its plain version at ``SSD_SHAPES``, with device
    times of the kernel and the plain version (no single PyTorch call
    computes the scan: library time null). Each row names the path it
    launched (f32 ``"fma"``, bf16 at the prefill shape ``"wgmma"``)."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.ref import ssd_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(5)
    flush = torch.empty(256 * 2 ** 20 // 4, device="cuda")
    rows = []
    for label, B, S, H, P, N, Q, dt_name in SSD_SHAPES:
        dtype = getattr(torch, dt_name)
        args = ssd_inputs(torch, gen, B, S, H, P, N, dtype)
        path = launched_path(ss, lambda: ss.ssd_scan(*args, chunk=Q))
        if path != ss.kernel_path(B, S, H, P, N, Q, dtype) or (
                dt_name == "float32" and path != "fma") or (
                label == "bf16" and path != "wgmma"):
            raise AssertionError(f"ssd_scan {label}: launched {path}")
        got = ss.ssd_scan(*args, chunk=Q)
        again = ss.ssd_scan(*args, chunk=Q)
        want = ssd_scan_ref(*args, chunk=Q)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ssd_scan {label}: not repeatable")
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   **SSD_TOL[dt_name])
        torch.testing.assert_close(got[1], want[1], **SSD_TOL["float32"])
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        del got, again, want
        flops, nbytes = ssd_work(B, S, H, P, N, Q)
        if dtype == torch.bfloat16:       # x, y, b, c in 2-byte elements
            nbytes -= 2 * (2 * B * S * H * P + 2 * B * S * N)
        rows.append(_row(
            "ssd_scan", label,
            {"b": B, "s": S, "h": H, "p": P, "n": N, "chunk": Q,
             "dtype": dt_name, "path": path}, err, SSD_TOL[dt_name],
            time_ms(torch, lambda: ss.ssd_scan(*args, chunk=Q), flush),
            time_ms(torch, lambda: ssd_scan_ref(*args, chunk=Q), flush),
            None, nbytes, flops, bw,
            f32_peak if dt_name == "float32" else bf16_peak))
        del args
    del flush
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the multi-device round (phase 10)
# ---------------------------------------------------------------------------

# the client-sharded kernels: the name in the kernels line, what it replaces
SHARDED_KERNELS = {
    "fedavg_reduce_sharded": "src/repro/kernels/fedavg_reduce.py:104",
    "int8_decompress_reduce_sharded": "src/repro/kernels/delta_codec.py:116",
    "int8_decode_apply_sharded": "src/repro/kernels/delta_codec.py:212",
    "topk_scatter_reduce_sharded": "src/repro/kernels/delta_codec.py:371",
}
# phase mesh's runs, CIFAR100 at paper width with aggregator="kernel":
# (label, uplink, downlink, mesh, reduce, rounds)
MESH_RUNS = [("kernel", None, None, "data", "flat", 2)] + [
    (f"{up}/{down}", up, down, "data", "flat", 2)
    for up, down in WIRE_CONFIGS] + [
    ("kernel.grouped", None, None, "pod_data", "grouped", 1)]


def init_world1(torch):
    """A one-rank NCCL group on the card (tcp://localhost on a free port)
    and its meshes: (1,) ("data",) and (1, 1) ("pod", "data")."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init_distributed("cuda", init_method=f"tcp://localhost:{port}", rank=0,
                     world_size=1)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"process group {dist.get_backend()}, want "
                             f"nccl on the card")
    return {"data": (make_mesh((1,), ("data",), "cuda"), ("data",)),
            "pod_data": (make_mesh((1, 1), ("pod", "data"), "cuda"),
                         ("pod", "data"))}


def phase_sharded_kernels(torch, bw: float, f32_peak: float, meshes):
    """The four sharded wrappers (the kernel on this rank's rows, then the
    NCCL collective) against their plain sharded versions (the plain body,
    then the same collective) at every CIFAR100 leaf (N = 25), with
    times of both; at one rank the collective moves no byte between
    devices, so the bound is the kernel's. No single PyTorch call computes
    a reduce across ranks: library time null."""
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(256 * 2 ** 20 // 4, device="cuda")
    dev = "cuda"
    mesh, axes = meshes["data"]
    kw = dict(mesh=mesh, client_axes=axes)
    rows = []
    for label, n, m in wire_leaf_shapes():
        if not label.startswith("cifar100."):
            continue
        x = torch.randn((n, m), generator=gen, device=dev)
        w = torch.softmax(torch.randn((n,), generator=gen, device=dev), 0)
        q = torch.randint(-127, 128, (n, m), generator=gen, device=dev,
                          dtype=torch.int8)
        refv = torch.randn((m,), generator=gen, device=dev)
        s = torch.full((1,), 3e-3, device=dev)
        k = math.ceil(TOPK_FRAC * m)
        idx = torch.stack([torch.randperm(m, generator=gen, device=dev)[:k]
                           for _ in range(n)]).to(torch.int32)
        vals = torch.randn(idx.shape, generator=gen, device=dev)
        w1 = w * 1e-4
        cases = [
            ("fedavg_reduce_sharded",
             lambda: fr.fedavg_reduce_sharded(x, w, **kw),
             lambda: ref.fedavg_reduce_sharded_ref(x, w, **kw),
             TOL["float32"], {"n": n, "m": m},
             4 * n * m + 4 * m + 4 * n, 2 * n * m),
            ("int8_decompress_reduce_sharded",
             lambda: dc.int8_decompress_reduce_sharded(q, w1, **kw),
             lambda: ref.int8_decompress_reduce_sharded_ref(q, w1, **kw),
             REDUCE_TOL, {"n": n, "m": m, "planes": 1},
             n * m + 4 * n + 4 * m, 2 * n * m),
            ("int8_decode_apply_sharded",
             lambda: dc.int8_decode_apply_sharded(refv, q[0], s, mesh=mesh,
                                                  axes=axes),
             lambda: ref.int8_decode_apply_sharded_ref(refv, q[0], s,
                                                       mesh=mesh, axes=axes),
             "exact", {"m": m, "planes": 1}, 8 * m + m + 4, 2 * m),
            ("topk_scatter_reduce_sharded",
             lambda: dc.topk_scatter_reduce_sharded(vals, idx, w, m, **kw),
             lambda: ref.topk_scatter_reduce_sharded_ref(vals, idx, w, m,
                                                         **kw),
             "exact", {"n": n, "m": m, "s": k, "design": TOPK_DESIGN},
             8 * n * k + 4 * n + 4 * m,
             2 * n * k),
        ]
        for name, fn, plain, tol, shape, nbytes, flops in cases:
            got, again = fn(), fn()
            want = plain()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name} {label}: not repeatable")
            if isinstance(tol, dict) and "rtol" in tol:
                torch.testing.assert_close(got, want, **tol)
                err = float((got - want).abs().max())
            else:
                err = _check(torch, got, want, tol, f"{name} {label}")
            rows.append(_row(name, label, {**shape, "world": 1}, err, tol,
                             time_ms(torch, fn, flush),
                             time_ms(torch, plain, flush), None, nbytes,
                             flops, bw, f32_peak))
        del x, q, refv, idx, vals
    del flush
    torch.cuda.empty_cache()
    return rows


def run_mesh(torch, data, up, down, backend, rounds: int):
    """``FedAvgTrainer(aggregator="kernel")`` on CIFAR100 at paper width
    with the codec pair and backend (None: local); returns the trainer,
    its History, ms per round (host clock) and the all-reduces' device ms
    per round (CUDA events)."""
    import torch.distributed as dist
    from repro_torch.configs import get_paper_task
    from repro_torch.core import FedAvgTrainer, RuntimeModel
    from repro_torch.models import small
    task = get_paper_task("cifar100")
    fed = dataclasses.replace(task.fed, k_schedule="rounds",
                              aggregator="kernel", rounds=rounds,
                              transport=up, downlink=down,
                              topk_frac=TOPK_FRAC)
    trainer = FedAvgTrainer(
        lambda p, b: small.task_loss(p, task, b),
        small.init_task_model(0, task), data, fed,
        RuntimeModel(task.model_size_mb, task.runtime,
                     fed.clients_per_round), backend=backend)

    # instrumentation of this script only: host clock around each round,
    # CUDA events around each all-reduce
    round_ms, events = [], []
    run_bucket, all_reduce = trainer.engine.run_bucket, dist.all_reduce

    def timed_bucket(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_bucket(*a)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_all_reduce(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = all_reduce(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    trainer.engine.run_bucket = timed_bucket
    dist.all_reduce = timed_all_reduce
    try:
        h = trainer.run(rounds)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    ar_ms = sum(a.elapsed_time(b) for a, b in events) / rounds
    return trainer, h, round_ms, ar_ms, len(events)


def phase_mesh(torch, data, meshes):
    """``FedAvgTrainer(backend=MeshBackend(...), aggregator="kernel")`` at
    one rank over NCCL on CIFAR100 at paper width (U 25, b 32, K 50, 40):
    plain uplink, the three wire pairs, and grouped reduce on the
    ("pod", "data") mesh; each run against the same rounds on
    ``LocalBackend``, params bit for bit. Counts zeroed before each mesh
    run: launches of each sharded kernel = rounds x leaves (one a call);
    all-reduces = rounds x leaves x tiers (x 2 with
    error feedback, whose true sum is all-reduced too); all-gathers =
    rounds x (2 for the losses: their lengths, then the rows; + leaves
    for the int8 downlink's sharded decode-apply). Returns the launches
    summed over the runs."""
    from repro_torch.optim import tree_leaves
    same = lambda a, b: all(torch.equal(x, y) for x, y in
                            zip(tree_leaves(a.params), tree_leaves(b.params)))
    # cuDNN's default convolution algorithms may sum a weight gradient with
    # atomics, in another order each run: two LocalBackend runs of the
    # CIFAR100 CNN are compared once as they are, and the phase then runs
    # with deterministic cuDNN algorithms so that bitwise means something
    first = run_mesh(torch, data, None, None, None, 1)[0]
    emit({"phase": "mesh", "what": "local run repeated, default cuDNN",
          "bitwise": same(first, run_mesh(torch, data, None, None, None,
                                          1)[0])})
    del first
    torch.backends.cudnn.deterministic = True
    try:
        return _mesh_runs(torch, data, meshes, same)
    finally:
        torch.backends.cudnn.deterministic = False


def _mesh_runs(torch, data, meshes, same):
    from repro_torch.core.engine.backends import MeshBackend
    from repro_torch.kernels import collectives
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.optim import tree_leaves
    totals = dict.fromkeys(SHARDED_KERNELS, 0)
    for label, up, down, mesh_name, reduce, rounds in MESH_RUNS:
        local, hl, local_ms, _, _ = run_mesh(torch, data, up, down, None,
                                             rounds)
        mesh, axes = meshes[mesh_name]
        fr.sharded_launches = 0
        for key in dc.sharded_launches:
            dc.sharded_launches[key] = 0
        for key in collectives.counts:
            collectives.counts[key] = 0
        tr, hm, mesh_ms, ar_ms, n_ar = run_mesh(
            torch, data, up, down, MeshBackend(mesh, reduce=reduce), rounds)
        launches = {"fedavg_reduce_sharded": fr.sharded_launches,
                    **dc.sharded_launches}
        counts = dict(collectives.counts)
        leaves, n = len(tree_leaves(tr.params)), tr.fed.clients_per_round
        tiers = len(axes) if reduce == "grouped" else 1
        ef = up in ("int8", "topk")
        int8_down = (down or "").startswith("int8")
        want = {"fedavg_reduce_sharded": rounds * leaves * (up is None),
                "int8_decompress_reduce_sharded":
                    rounds * leaves * (up or "").startswith("int8"),
                "int8_decode_apply_sharded": rounds * leaves * int8_down,
                "topk_scatter_reduce_sharded":
                    rounds * leaves * (up == "topk")}
        want_counts = {"all_reduce": rounds * leaves * tiers * (1 + ef),
                       "all_gather": rounds * (2 + leaves * int8_down)}
        if launches != want or counts != want_counts:
            raise AssertionError(f"mesh {label}: launches {launches}, "
                                 f"collectives {counts}; want {want}, "
                                 f"{want_counts}")
        if not same(tr, local) or hm.train_loss != hl.train_loss or \
                (hm.k, hm.wall_clock_s, hm.uplink_mbit, hm.downlink_mbit) \
                != (hl.k, hl.wall_clock_s, hl.uplink_mbit,
                    hl.downlink_mbit):
            raise AssertionError(f"mesh {label}: not bitwise LocalBackend's "
                                 f"rounds (params equal: {same(tr, local)})")
        if not all(math.isfinite(v) for v in hm.train_loss):
            raise AssertionError(f"mesh {label}: loss {hm.train_loss}")
        for key, v in launches.items():
            totals[key] += v
        emit({"phase": "mesh", "run": label, "uplink": up, "downlink": down,
              "mesh": mesh_name, "reduce": reduce, "world": 1,
              "backend": "nccl", "rounds": rounds, "k": hm.k,
              "loss": hm.train_loss, "launches": launches,
              "collectives": counts, "all_reduces_timed": n_ar,
              "bitwise_local": True,
              "ms_per_round": sum(mesh_ms) / rounds, "ms_rounds": mesh_ms,
              "local_ms_per_round": sum(local_ms) / rounds,
              "local_ms_rounds": local_ms,
              "all_reduce_ms_per_round": ar_ms})
        del tr, local
        torch.cuda.empty_cache()
    return totals


# the two-rank gloo run on the one card: the sharded kernels at every
# CIFAR100 leaf, and one round of the mesh trainer
GLOO_WORLD = 2


def _leaf_inputs(torch, m: int, seed: int):
    """The sharded kernels' inputs at one leaf (N = 25 rows), drawn on the
    host from ``seed``, so every rank and the one-rank run get the same."""
    gen = torch.Generator().manual_seed(seed)
    n, k = 25, math.ceil(TOPK_FRAC * m)
    return {"x": torch.randn((n, m), generator=gen),
            "w": torch.softmax(torch.randn((n,), generator=gen), 0),
            "q": torch.randint(-127, 128, (n, m), generator=gen,
                               dtype=torch.int8),
            "ref": torch.randn((m,), generator=gen),
            "s": torch.full((1,), 3e-3),
            "idx": torch.stack([torch.randperm(m, generator=gen)[:k]
                                for _ in range(n)]).to(torch.int32),
            "vals": torch.randn((n, k), generator=gen)}


def _sharded_at_leaves(torch, mesh, axes, rows):
    """The four sharded wrappers at every CIFAR100 leaf on this rank's
    ``rows`` of the leaf's inputs (on the card); results on the host."""
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    out = {}
    leaves = [(label, m) for label, _, m in wire_leaf_shapes()
              if label.startswith("cifar100.")]
    for i, (label, m) in enumerate(leaves):
        t = {k: v.cuda() for k, v in _leaf_inputs(torch, m, i).items()}
        r = {k: t[k][rows[0]:rows[1]] for k in ("x", "w", "q", "idx",
                                                 "vals")}
        kw = dict(mesh=mesh, client_axes=axes)
        got = {"fedavg_reduce_sharded":
               fr.fedavg_reduce_sharded(r["x"], r["w"], **kw),
               "int8_decompress_reduce_sharded":
               dc.int8_decompress_reduce_sharded(r["q"], r["w"] * 1e-4, **kw),
               "int8_decode_apply_sharded":
               dc.int8_decode_apply_sharded(t["ref"], t["q"][0], t["s"],
                                            mesh=mesh, axes=axes),
               "topk_scatter_reduce_sharded":
               dc.topk_scatter_reduce_sharded(r["vals"], r["idx"], r["w"], m,
                                              **kw)}
        out.update({(name, label): v.cpu() for name, v in got.items()})
    return out


def gloo_rank(rank: int, world: int, path: str, out: str) -> None:
    """One rank of the gloo run on the card (a spawned process): the
    sharded kernels on its rows, then one CIFAR100 round of the mesh
    trainer; writes both for the parent."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.core.engine.backends import MeshBackend
    from repro_torch.kernels.collectives import rows_of
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((world,), ("data",), "cuda")
        res = {"rows": rows_of(mesh, ("data",), 25),
               "kernels": _sharded_at_leaves(
                   torch, mesh, ("data",), rows_of(mesh, ("data",), 25))}
        data, _ = paper_data("cifar100")
        tr, h, ms, _, _ = run_mesh(torch, data, None, None,
                                   MeshBackend(mesh), 1)
        res["params"] = {k: v.cpu() for k, v in leaf_items(tr.params, "")}
        res["loss"], res["ms"] = h.train_loss, ms
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_mesh_gloo(torch, data):
    """Two gloo ranks spawned on the one card, each launching the CUDA
    kernels on its rows (25 = 13 + 12) and all-reducing through gloo:
    every sharded kernel at every CIFAR100 leaf within 1e-6 of the
    one-rank result, and one paper-width CIFAR100 round of the mesh
    trainer against the same round on ``LocalBackend``, both with
    deterministic cuDNN (parameters within the port's parity tolerance
    1e-4: each rank's vmapped CNN sees 13 or 12 clients, not 25, and 50
    local steps carry the difference forward)."""
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    tmp = tempfile.mkdtemp()
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=gloo_rank, args=(r, GLOO_WORLD,
                                                  os.path.join(tmp, "pg"),
                                                  tmp))
             for r in range(GLOO_WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"gloo ranks exited "
                             f"{[p.exitcode for p in procs]}")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                        weights_only=False) for r in range(GLOO_WORLD)]
    # the one-rank results: the unsharded kernels on all 25 rows
    want = {}
    leaves = [(label, m) for label, _, m in wire_leaf_shapes()
              if label.startswith("cifar100.")]
    for i, (label, m) in enumerate(leaves):
        t = {k: v.cuda() for k, v in _leaf_inputs(torch, m, i).items()}
        want[("fedavg_reduce_sharded", label)] = fr.fedavg_reduce(
            t["x"], t["w"])
        want[("int8_decompress_reduce_sharded", label)] = \
            dc.int8_decompress_reduce(t["q"], t["w"] * 1e-4)
        want[("int8_decode_apply_sharded", label)] = dc.int8_decode_apply(
            t["ref"], t["q"][0], t["s"])
        want[("topk_scatter_reduce_sharded", label)] = \
            dc.topk_scatter_reduce(t["vals"], t["idx"], t["w"], m)
    err = dict.fromkeys(SHARDED_KERNELS, 0.0)
    for key, w in want.items():
        w = w.cpu()
        for res in ranks:
            e = float((res["kernels"][key] - w).abs().max())
            if e > 1e-6:
                raise AssertionError(f"gloo {key}: {e} from one rank")
            err[key[0]] = max(err[key[0]], e)
    for res in ranks[1:]:
        for k, v in res["params"].items():
            if not torch.equal(v, ranks[0]["params"][k]):
                raise AssertionError(f"gloo: ranks disagree on {k}")
    torch.backends.cudnn.deterministic = True       # as the ranks run
    try:
        local = run_mesh(torch, data, None, None, None, 1)[0]
    finally:
        torch.backends.cudnn.deterministic = False
    p_err = 0.0
    for k, v in leaf_items(local.params, ""):
        torch.testing.assert_close(ranks[0]["params"][k], v.cpu(),
                                   rtol=1e-4, atol=1e-4)
        p_err = max(p_err, float((ranks[0]["params"][k] - v.cpu())
                                 .abs().max()))
    emit({"phase": "mesh", "run": "gloo", "world": GLOO_WORLD,
          "backend": "gloo", "device": "cuda:0 (one card, both ranks)",
          "rows": [r["rows"] for r in ranks],
          "kernels_max_abs_err_vs_one_rank": err, "tol": 1e-6,
          "round_params_max_abs_err_vs_local": p_err,
          "round_loss": ranks[0]["loss"], "round_ms": ranks[0]["ms"],
          "spawn_s": spawn_s})
    del local


# ---------------------------------------------------------------------------
# federated LM training (phase 11)
# ---------------------------------------------------------------------------

# the configurations of phase lm_train, each a key of
# ``launch/lm_train_timing.py``'s ``CONFIGS`` (the LM specs' traffic
# there: 12 clients, 4 a round, b 4, seq 32, K_r-rounds, eta0 0.05, beta
# 0.05 s a local step), and where each comes from
LM_TRAIN_SOURCES = {
    "a": "examples/specs/local-int8-decayK.json",
    "b": "examples/specs/local-int8-downlink.json",
    "c": "examples/specs/fixed-cohort-topk.json",
    "d": "local-int8-decayK's traffic, no transport, aggregator kernel"}
LM_TRAIN_ROUNDS = 3
# the wire path's kernel entry points in kernels.ops
WIRE_ENTRIES = {"int8_decompress_reduce": "int8_delta_reduce",
                "int8_decode_apply": "int8_delta_apply",
                "topk_scatter_reduce": "topk_delta_reduce",
                "topk_scatter_apply": "topk_delta_apply"}
# the embedding leaf of qwen1.5-0.5b (151,936 x 1,024) at the specs' 4
# clients a round, and the top-k fraction of fixed-cohort-topk
LM_LEAF = ("qwen1.5-0.5b.embed", 4, 155_582_464)
LM_TOPK_FRAC = 0.25


def lm_train_want(fed, sizes, rounds: int):
    """K_r and the cumulative History counters the RuntimeModel formula
    (Eq. 3, homogeneous clients, the default 20 / 5 Mbit/s links) gives,
    computed here from the leaf sizes: |x| is the params at 4 bytes, and
    each leg's Mbit is |x| over the codec's ratio (full bits over the
    encoded bits: int8 a byte a value and a scale a leaf, top-k a value
    and an index a kept coordinate)."""
    from repro_torch.launch.lm_train_timing import BETA
    ks = [min(max(math.ceil(fed.k0 / r ** (1.0 / 3.0)), fed.k_min), fed.k0)
          for r in range(1, rounds + 1)]
    size = sum(sizes) * 4 * 8 / 1e6

    def ratio(codec):
        if codec in (None, "none"):
            return 1.0
        if codec == "int8":
            bits = sum(8 * m + 32 for m in sizes)
        else:
            bits = sum(64 * min(m, max(1, math.ceil(fed.topk_frac * m)))
                       for m in sizes)
        return 32 * sum(sizes) / float(bits)

    up, down = size / ratio(fed.transport), size / ratio(fed.downlink)
    n = fed.clients_per_round
    want = {"k": ks, "sgd_steps": [], "wall_clock_s": [], "uplink_mbit": [],
            "downlink_mbit": []}
    wall, steps, up_t, down_t = 0.0, 0, 0.0, 0.0
    for k in ks:
        wall += down / 20.0 + k * BETA + up / 5.0
        steps += k * n
        up_t += up * n
        down_t += down * n
        for key, v in (("sgd_steps", steps), ("wall_clock_s", wall),
                       ("uplink_mbit", up_t), ("downlink_mbit", down_t)):
            want[key].append(v)
    return want


def record_ids(trainer):
    """Instrumentation of this script only: the client ids of every round
    the trainer's sampler draws."""
    ids, sample = [], trainer.sampler.round

    def round_(*a, **kw):
        out = sample(*a, **kw)
        ids.append([int(c) for c in out[0]])
        return out

    trainer.sampler.round = round_
    return ids


def check_lm_round(torch, trainer, label):
    """One round more of ``trainer``, after its counts were read: each call
    of a wire entry point and of the tree reduce is held against its plain
    version (``kernels.ref``) on the same inputs, at every leaf size of the
    model. Returns, for each kernel that ran, its calls, leaf sizes, max
    abs error and tolerance."""
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import tree_leaves
    plain = {"int8_decompress_reduce": (ref.int8_decompress_reduce_ref,
                                        REDUCE_TOL),
             "int8_decode_apply": (ref.int8_decode_apply_ref, "exact"),
             "topk_scatter_reduce": (ref.topk_scatter_reduce_ref, "exact"),
             "topk_scatter_apply": (ref.topk_scatter_apply_ref, "exact")}
    seen = {}

    def note(key, ms, err, tol):
        r = seen.setdefault(key, {"calls": 0, "m": [], "max_abs_err": 0.0,
                                  "tol": tol})
        r["calls"] += 1
        r["m"] += ms
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def checked(key, fn):
        want_fn, tol = plain[key]

        def call(*a):
            out = fn(*a)
            err = _check(torch, out, want_fn(*a), tol,
                         f"lm_train ({label}) {key} at M {out.numel()}")
            note(key, [out.numel()], err, tol)
            return out
        return call

    def checked_tree(fn):
        def call(tree, w):
            out = fn(tree, w)
            ms, err = [], 0.0
            for x, g in zip(tree_leaves(tree), tree_leaves(out)):
                want = ref.fedavg_reduce_ref(x.reshape(x.shape[0], -1), w)
                torch.testing.assert_close(
                    g.reshape(-1), want, **TOL["float32"],
                    msg=lambda m: f"lm_train ({label}) fedavg_reduce_tree "
                    f"at M {g.numel()}: {m}")
                ms.append(g.numel())
                err = max(err, float((g.reshape(-1) - want).abs().max()))
            note("fedavg_reduce", ms, err, TOL["float32"])
            return out
        return call

    saved = {fn: getattr(ops, fn) for fn in WIRE_ENTRIES.values()}
    saved["fedavg_reduce_tree"] = ops.fedavg_reduce_tree
    for key, fn in WIRE_ENTRIES.items():
        setattr(ops, fn, checked(key, saved[fn]))
    ops.fedavg_reduce_tree = checked_tree(saved["fedavg_reduce_tree"])
    try:
        h = trainer.run(1)
        torch.cuda.synchronize()
    finally:
        for fn, f in saved.items():
            setattr(ops, fn, f)
    if not math.isfinite(h.train_loss[-1]):
        raise AssertionError(f"lm_train ({label}): checked round's loss "
                             f"{h.train_loss[-1]}")
    return seen


def run_lm_train(torch, label, cfg, params, data):
    """``FedAvgTrainer`` on qwen1.5-0.5b at full width for
    ``LM_TRAIN_ROUNDS`` rounds in configuration ``label`` of
    ``LM_TRAIN_SOURCES``; every count zeroed just before the run. Returns
    the launches of the four wire kernels and of ``fedavg_reduce``."""
    from repro_torch.core.engine.backends import local
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.launch.lm_train_timing import SEQ, BETA, make_trainer
    from repro_torch.optim import tree_leaves
    rounds = LM_TRAIN_ROUNDS
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    sizes = [int(t.numel()) for t in leaves]

    # instrumentation of this script only: host clock around each round,
    # CUDA events around the vmapped client update (its K local steps),
    # each kernel entry point, each encoder and the tree reduce
    round_ms, events = [], {}

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

    make_update = local.make_client_update
    local.make_client_update = lambda fn: timed("client_update",
                                                make_update(fn))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer = make_trainer(label, rounds, cfg, params, data)
    finally:
        local.make_client_update = make_update
    fed = trainer.fed
    ids = record_ids(trainer)
    run_bucket = trainer.engine.run_bucket

    def timed_bucket(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_bucket(*a)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t) * 1e3)
        return out

    trainer.engine.run_bucket = timed_bucket
    entries = {**WIRE_ENTRIES, "fedavg_reduce": "fedavg_reduce_tree"}
    saved = {fn: getattr(ops, fn) for fn in entries.values()}
    for key, fn in entries.items():
        setattr(ops, fn, timed(key, saved[fn]))
    codecs = {"encode_up": trainer.engine.transport,
              "encode_down": getattr(trainer.engine.downlink, "codec",
                                     None)}
    for key, codec in codecs.items():
        if codec is not None:
            codec.encode = timed(key, codec.encode)
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
    launches = {**dc.launches, "fedavg_reduce": fr.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9

    up, down = fed.transport, fed.downlink
    want = dict.fromkeys(launches, 0)
    if up == "int8":
        want["int8_decompress_reduce"] = rounds * len(leaves)
    if up == "topk":
        want["topk_scatter_reduce"] = rounds * len(leaves)
    if down == "int8":
        want["int8_decode_apply"] = rounds * len(leaves)
    if fed.aggregator == "kernel" and up == "none":
        want["fedavg_reduce"] = rounds * math.ceil(len(leaves)
                                                   / fr.MAX_LEAVES)
    if launches != want:
        raise AssertionError(f"lm_train ({label}): launches {launches}, "
                             f"want {want}")
    counters = lm_train_want(fed, sizes, rounds)
    got = {key: getattr(h, key) for key in counters}
    if got != counters:
        raise AssertionError(f"lm_train ({label}): counters {got} != the "
                             f"RuntimeModel formula's {counters}")
    want_ids = ([list(fed.cohort)] * rounds if fed.sampler == "fixed_cohort"
                else None)
    if len(ids) != rounds or (want_ids and ids != want_ids):
        raise AssertionError(f"lm_train ({label}): client ids {ids}")
    if not all(math.isfinite(v) for v in h.train_loss):
        raise AssertionError(f"lm_train ({label}): loss {h.train_loss}")
    ef = trainer.engine.transport_state
    ef_shape = (list(tree_leaves(ef)[0].shape[:1])
                if tree_leaves(ef) else None)
    if fed.sampler == "fixed_cohort" and (
            trainer.engine.transport.ef_slots != fed.clients_per_round
            or ef_shape != [fed.clients_per_round]):
        raise AssertionError(f"lm_train ({label}): residual slots "
                             f"{ef_shape}, want {fed.clients_per_round}")
    dev_ms = {key: [a.elapsed_time(b) for a, b in evs]
              for key, evs in events.items()}
    client_ms = dev_ms.pop("client_update")
    # each key's calls are the same number a round, in round order
    per_round = {key: [sum(v[i * len(v) // rounds:(i + 1) * len(v)
                             // rounds]) for i in range(rounds)]
                 for key, v in dev_ms.items()}
    kernel_keys = [k for k in per_round if k in entries]
    for i in range(rounds):
        emit({"phase": "lm_train", "config": label, "round": h.rounds[i],
              "k": h.k[i], "ids": ids[i], "loss": h.train_loss[i],
              "ms": round_ms[i], "client_update_ms": client_ms[i],
              "ms_per_local_step": client_ms[i] / h.k[i],
              "device_ms": {key: v[i] for key, v in per_round.items()},
              "wire_kernel_share": sum(per_round[k][i]
                                       for k in kernel_keys) / round_ms[i],
              "sgd_steps": h.sgd_steps[i],
              "wall_clock_s": h.wall_clock_s[i],
              "uplink_mbit": h.uplink_mbit[i],
              "downlink_mbit": h.downlink_mbit[i]})
    emit({"phase": "lm_train", "config": label, "summary": True,
          "source": LM_TRAIN_SOURCES[label], "arch": cfg.name,
          "params": n_params,
          "leaves": len(leaves), "dtype": "float32",
          "fed": {k: getattr(fed, k) for k in (
              "total_clients", "clients_per_round", "batch_size", "k0",
              "eta0", "k_schedule", "transport", "downlink", "topk_frac",
              "sampler", "cohort", "aggregator")},
          "seq": SEQ, "beta_seconds": BETA,
          "ef_slots": trainer.engine.transport.ef_slots
          if trainer.engine.transport is not None else None,
          "k": h.k, "loss": h.train_loss, "counters_exact": True,
          "launches": launches, "ms_per_round": sum(round_ms) / rounds,
          "ms_per_local_step": sum(client_ms) / sum(h.k),
          "device_ms_per_round": {key: sum(v) / rounds
                                  for key, v in per_round.items()},
          "wire_kernel_share": sum(sum(per_round[k]) for k in kernel_keys)
          / sum(round_ms),
          "run_s": run_s, "peak_mem_gb": peak})
    # after the timed rounds were read (the timing wrappers stay on)
    checked = check_lm_round(torch, trainer, label)
    want_checked = {k: v // rounds for k, v in want.items() if v}
    if {k: v["calls"] for k, v in checked.items()} != want_checked \
            or any(v["m"] != sizes for v in checked.values()):
        raise AssertionError(f"lm_train ({label}): checked round ran "
                             f"{checked}, want {want_checked} at {sizes}")
    emit({"phase": "lm_train", "config": label, "checked_round": {
        k: {"calls": v["calls"], "leaves": len(v["m"]),
            "max_abs_err": v["max_abs_err"], "tol": v["tol"]}
        for k, v in checked.items()}})
    return launches


def phase_lm_train(torch, params):
    """qwen1.5-0.5b at full width (phase ``lm``'s f32 params, not drawn
    again) trained for ``LM_TRAIN_ROUNDS`` rounds in each configuration of
    ``LM_TRAIN_SOURCES``, on ``make_lm_clients(default_rng(0), 12,
    vocab=151936, seq_len=32)``. The params are read, never written: each
    configuration starts from them. Returns each kernel's launches summed
    over the configurations."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.lm_train_timing import SEQ, lm_data
    from repro_torch.optim import tree_leaves
    cfg = get_arch(LM_ARCH)
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != LM_PARAMS:
        raise AssertionError(f"lm_train: {n_params} params, want "
                             f"{LM_PARAMS}")
    t0 = time.perf_counter()
    data = lm_data(cfg)
    emit({"phase": "lm_train", "what": "data", "clients": data.num_clients,
          "vocab": cfg.vocab_size, "seq": SEQ,
          "build_s": time.perf_counter() - t0})
    digest = [float(t.double().sum()) for t in tree_leaves(params)]
    total = {}
    for label in LM_TRAIN_SOURCES:
        for k, v in run_lm_train(torch, label, cfg, params, data).items():
            total[k] = total.get(k, 0) + v
        # the timing wrappers hold the trainer in reference cycles: free its
        # params and codec state (up to ~10 GB) before the next phase
        gc.collect()
        torch.cuda.empty_cache()
        if [float(t.double().sum()) for t in tree_leaves(params)] != digest:
            raise AssertionError(f"lm_train ({label}) wrote the initial "
                                 f"params")
    return total


def phase_parity_lm_train(torch):
    """One ``FedAvgTrainer`` round on the card (kernels) against the same
    round on the CPU (plain versions), same data and weights: reduced
    qwen1.5-0.5b on spec (a) (int8 uplink), and reduced phi3.5-moe on the
    dispatch path through the kernel aggregator. Counters and client ids
    exact; losses within the CIFAR100 parity tolerance (1e-4); parameters
    within it too, plus one quantisation step of the round's movement of
    each leaf (/127) for the int8 round, as phase ``parity``'s wire
    round."""
    import numpy as np
    from repro_torch.launch.lm_train_timing import lm_data, make_trainer
    from repro_torch.models import registry
    from repro_torch.optim import tree_map
    tol = dict(rtol=1e-4, atol=1e-4)
    # (reduced arch, configuration): (a) and (d) of LM_TRAIN_SOURCES
    for name, label in (("qwen1.5-0.5b-reduced", "a"),
                        ("phi3.5-moe-42b-a6.6b-reduced", "d")):
        cfg = lm_config(name)
        data = lm_data(cfg)
        params = registry.init(0, cfg, device="cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            tr = make_trainer(label, 1, cfg, tree_map(lambda t: t.to(dev),
                                                      params), data,
                              device=dev)
            ids = record_ids(tr)
            out[dev] = (tr.run(1), ids, tr.params)
        fed = tr.fed
        (hc, ic, pc), (hg, ig, pg) = out["cpu"], out["cuda"]
        keys = ("rounds", "k", "eta", "sgd_steps", "wall_clock_s",
                "uplink_mbit", "downlink_mbit")
        if ic != ig or any(getattr(hc, k) != getattr(hg, k) for k in keys):
            raise AssertionError(f"{name} round: ids {ig} vs {ic} or "
                                 f"counters differ")
        np.testing.assert_allclose(hg.train_loss, hc.train_loss, **tol)
        err, worst = 0.0, 0.0
        int8 = fed.transport == "int8"
        for (path, old), (_, a), (_, b) in zip(leaf_items(params, ""),
                                                leaf_items(pc, ""),
                                                leaf_items(pg, "")):
            step = float((a - old).abs().max()) / 127.0 if int8 else 0.0
            torch.testing.assert_close(b.cpu(), a, rtol=tol["rtol"],
                                       atol=tol["atol"] + step,
                                       msg=lambda m: f"{name} {path}: {m}")
            d = (b.cpu() - a).abs()
            err = max(err, float(d.max()))
            worst = max(worst, float((d / (tol["atol"] + step + tol["rtol"]
                                           * a.abs())).max()))
        emit({"phase": "parity", "what": f"{name}: one FedAvgTrainer round "
              f"(k0 {fed.k0}, transport {fed.transport}, aggregator "
              f"{fed.aggregator}), cuda vs cpu",
              "ids": ig, "k": hg.k, "loss_cuda": hg.train_loss,
              "loss_cpu": hc.train_loss, "params_max_abs_err": err,
              "tol": {**tol, "int8_step": int8},
              "worst_share_of_tol": worst})


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
    bw, f32_peak, bf16_peak = card_peaks(name)
    phase_build()
    rows, max_err = phase_kernel(torch, bw, f32_peak)
    wrows = phase_wire_kernels(torch, bw, f32_peak)
    # each kernel's row at qwen's embedding leaf (fedavg_reduce from phase
    # kernel's rows, the wire kernels' one-plane and top-k 0.25 rows)
    lm_rows = {r["name"]: r for r in rows + wrows
               if r["shape"] == LM_LEAF[0] and r.get("planes", 1) == 1
               and r.get("dtype", "float32") == "float32"}
    frows = phase_flash_kernel(torch, bw, f32_peak, bf16_peak)
    grows = phase_gmm_kernel(torch, bw, f32_peak, bf16_peak)
    srows = phase_ssd_kernel(torch, bw, f32_peak, bf16_peak)
    phase_parity(torch)
    phase_parity_wire(torch)
    phase_parity_lm(torch)
    phase_parity_lm(torch, SSM_PARITY)
    phase_parity_lm_train(torch)
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
    import torch.distributed as dist
    meshes = init_world1(torch)
    try:
        mrows = phase_sharded_kernels(torch, bw, f32_peak, meshes)
        mesh_launches = phase_mesh(torch, cifar, meshes)
    finally:
        dist.destroy_process_group()
    phase_mesh_gloo(torch, cifar)
    if not all(mesh_launches.values()):
        raise AssertionError(f"a sharded kernel never ran: {mesh_launches}")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    lm_launches, params = phase_lm(torch)
    flash_launches = lm_launches["flash_attention"]
    lm_cfg = get_arch(LM_ARCH)
    lm_bf16 = phase_bf16_prefill(
        torch, "lm", lm_cfg, params,
        {"flash": (fa, "flash_attention", lm_cfg.num_layers)}, 7)
    train_launches = phase_lm_train(torch, params)
    if not all(train_launches[k] for k in ("int8_decompress_reduce",
                                           "int8_decode_apply",
                                           "topk_scatter_reduce",
                                           "fedavg_reduce")):
        raise AssertionError(f"a kernel of lm_train never ran: "
                             f"{train_launches}")
    del params
    moe_launches, params = phase_moe(torch)
    moe_cfg = dataclasses.replace(get_arch(MOE_ARCH), num_layers=MOE_LAYERS)
    moe_bf16 = phase_bf16_prefill(
        torch, "moe", moe_cfg, params,
        {"gmm": (mg, "gmm", 3 * MOE_LAYERS),
         "flash": (fa, "flash_attention", MOE_LAYERS)}, 8)
    del params
    ssm_fields = lambda cfg: {
        "layers": cfg.num_layers, "d_model": cfg.d_model,
        "ssm_heads": cfg.ssm.n_heads(cfg.d_model),
        "d_state": cfg.ssm.d_state, "chunk": cfg.ssm.chunk_size,
        "attn_layers": layer_count(cfg, "attn"),
        "head_dim": cfg.head_dim}
    from repro_torch.kernels import ssd_scan as ss
    ssm_launches, params = phase_lm(torch, "ssm", SSM_ARCH, SSM_PARAMS,
                                    (SSD,), 9, SSM_STATE_TOL, ssm_fields)
    ssd_launches = ssm_launches["ssd_scan"]
    ssm_cfg = get_arch(SSM_ARCH)
    ssm_bf16 = phase_bf16_prefill(
        torch, "ssm", ssm_cfg, params,
        {"ssd": (ss, "ssd_scan", ssm_cfg.num_layers)}, 9)
    del params
    phase_lm(torch, "zamba2", ZAMBA_ARCH, ZAMBA_PARAMS, (FLASH, SSD), 11,
             SSM_STATE_TOL, ssm_fields)

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

    # fedavg_reduce: one CIFAR100 round, the tree as one launch
    cifar_tree = next(r for r in rows if r["shape"] == "cifar100.tree")
    kernels = [{"name": "fedavg_reduce", "route": "cuda",
                "source": "src/repro_torch/csrc/fedavg_reduce.cu",
                "replaces": "src/repro/kernels/fedavg_reduce.py:81",
                "launches": launches, "max_abs_err": max_err,
                **{key: cifar_tree[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "ms_clean", "library_ms_clean")}}]
    for kname, replaces in WIRE_KERNELS.items():
        mine = [r for r in wrows if r["name"] == kname]
        err = max(r["max_abs_err"] for r in mine)
        per_round = [r for r in mine if r.get("planes", 1) == 1]
        kernels.append(summary(kname, "src/repro_torch/csrc/delta_codec.cu",
                               replaces, wire_launches[kname], per_round,
                               err))
        if kname.startswith("topk"):
            kernels[-1]["design"] = TOPK_DESIGN
    # the sharded kernels: one CIFAR100 round (eight leaves, one plane),
    # each kernel with its NCCL collective at one rank
    for kname, replaces in SHARDED_KERNELS.items():
        mine = [r for r in mrows if r["name"] == kname]
        src = ("src/repro_torch/csrc/fedavg_reduce.cu"
               if kname.startswith("fedavg") else
               "src/repro_torch/csrc/delta_codec.cu")
        kernels.append(summary(kname, src, replaces, mesh_launches[kname],
                               mine, max(r["max_abs_err"] for r in mine)))
        if kname.startswith("topk"):
            kernels[-1]["design"] = TOPK_DESIGN
    # flash_attention and gmm: the full-width prefill's shape (one launch of
    # it; gmm at gate/up) in f32 (the "wgmma_split" path), and the same in
    # bf16 ("wgmma") with the launches of the bf16 prefills
    def row_of(rows, label, dt):
        return next(r for r in rows if r["shape"] == label
                    and r["dtype"] == dt)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for kname, src, replaces, rows, label, f32_launches, bf16_launches in (
            ("flash_attention", "flash_attention.cu", "flash_attention.py:114",
             frows, "prefill", flash_launches,
             lm_bf16["flash"] + moe_bf16["flash"]),
            ("gmm", "moe_gmm.cu", "moe_gmm.py:61", grows, "gate_up",
             moe_launches["gmm"], moe_bf16["gmm"])):
        f32, bf16 = row_of(rows, label, "float32"), row_of(
            rows, "bf16" if label == "prefill" else label, "bfloat16")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": f32_launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{key: f32[key] for key in keys}, "path": f32["path"],
            "bf16_launches": bf16_launches,
            **{f"bf16_{key}": bf16[key] for key in keys},
            "bf16_path": bf16["path"]})
    # ssd_scan: the full-width prefill's shape (one launch of it) in f32
    # (the FMA path) and in bf16 (the tensor-core path) with the launches
    # of the bf16 prefill
    f32, bf16 = row_of(srows, "prefill", "float32"), row_of(
        srows, "bf16", "bfloat16")
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:87",
        "launches": ssd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in srows),
        **{key: f32[key] for key in keys}, "path": f32["path"],
        "bf16_launches": ssm_bf16["ssd"],
        **{f"bf16_{key}": bf16[key] for key in keys},
        "bf16_path": bf16["path"]})
    # the LM path: launches in phase lm_train and each row at qwen's
    # embedding leaf
    for entry in kernels:
        if entry["name"] in train_launches:
            entry["lm_train_launches"] = train_launches[entry["name"]]
        if entry["name"] in lm_rows:
            r = lm_rows[entry["name"]]
            entry["lm_leaf"] = {key: r.get(key) for key in (
                "n", "m", "s", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
