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
              ``fedavg_reduce`` launch a round for the whole tree); each
              engine dispatch runs a whole bucket: ms a bucket, and a
              round's ms is its bucket's over the bucket's active rounds;
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
              phase lm;
12. spec    — the spec-driven entry point (``repro_torch.api``, the
              launchers): (i) ``local-int8-decayK`` with
              ``model.reduced=false`` (qwen1.5-0.5b at full width) through
              ``launch.train`` for 2 rounds with ``--checkpoint``, then
              ``FederatedExperiment.restore`` and a resume to round 4, held
              against two uninterrupted ``build(spec).run(4)``: counters and
              client ids exact, params and losses bitwise when the two
              uninterrupted runs are, else within their difference
              (``repeat_max_abs_diff``); 14 ``int8_decompress_reduce``
              launches a round; ms a round, checkpoint bytes, save and
              restore seconds, peak memory; (ii) ``launch.serve
              --checkpoint`` on that checkpoint: the served params bitwise
              the saved ones, tokens/s at batch 4; (iii) reduced
              ``fixed-cohort-topk`` through ``build``, saved after 2 of 3
              rounds, its residual slots (leading axis 4) restored, held by
              the same rule, ``topk_scatter_reduce`` launches; (iv) a
              CIFAR100 spec with ``fed.aggregator=kernel`` at its paper
              FedConfig through ``launch.train`` for 2 rounds, one
              ``fedavg_reduce`` launch a round; (v) ``launch.quickstart
              --rounds 10``. Checkpoints live in a temporary directory the
              phase removes;
13. stream  — streaming cohorts (``fed.cohort_chunk``), after phase spec:
              (i) CIFAR100 at paper width (U 25, b 32, K0 50, kernel
              aggregator, cuDNN deterministic) 2 rounds dense, as one slab
              of 25 (bitwise dense) and in slabs of 3 (eight and a tail of
              1; within ``STREAM_TOL``), ``fedavg_reduce`` launches 2, 2,
              18, the allocator's peak dense over C = 3 at least 4x, ms a
              round; (ii) qwen1.5-0.5b at full width (phase lm's params)
              at the LM specs' traffic with the int8 uplink, 32 clients,
              16 a round in 4 slabs of 4, 2 rounds: 14 x 4 x 2
              ``int8_decompress_reduce`` launches, counters exact, ms a
              round, peak; one slab round more holds every call at the 14
              leaf sizes against its plain version; one round of U 4 as one
              slab bitwise the dense U 4 round; (iii)
              ``population-chunked.json`` through ``launch.train`` (20
              rounds, 8 slabs of 4, int8: 6 x 8 x 20 launches) and the same
              spec at C = 32 bitwise its dense run for 2 rounds; (iv)
              reduced ``fixed-cohort-topk`` dense, C = 4 (bitwise dense)
              and C = 2, every slab's top-k reduce held exactly;
14. async   — async buffered aggregation (``AsyncBufferedEngine``): (i)
              ``async-buffered.json`` through ``launch.train`` (12
              applications; ``int8_decompress_reduce`` launches 6 a fold),
              saved after 4, restored, resumed to 12 bitwise the
              uninterrupted run (history, params, residual slots,
              staleness histogram); (ii) the sync-parity oracle against
              ``FedAvgTrainer``; (iii) qwen1.5-0.5b at full width, 12
              clients, 4 in flight, buffer 2, ``inv``, max staleness 4,
              heterogeneity 0.8, int8: 14 launches a fold, ms an
              application, peak; one application more holds every fold's
              call (N = 1) at the 14 leaf sizes against its plain version;
15. serve_train — serving while training: (i)
              ``serve-while-training.json`` with ``model.reduced=false``
              (qwen1.5-0.5b at full width, 6 rounds, int8 both ways on a q8
              store, a ``ServingLoop`` tick every 2 rounds at 50 qps x 2
              ms) through ``launch.train``: 14 launches a round of each
              int8 kernel, ticks at rounds 2, 4, 6 with the staleness the
              reference defines (2: the rounds since the last swap), the
              served tree bitwise the q8 store's load, every round's wall
              clock exactly the Eq. 3 formula x 1/(1 - rho) and
              serve_queries 50 x the wall; tokens/s and swap us a tick;
              the last tick's decode repeated on the CPU from the same
              snapshot (ids equal wherever the top-2 gap allows); one round
              more holds every wire call against its plain version; then
              the read-only rule: with ``fed.bucket_rounds=1``, serving on
              and off give the same params, losses, steps and wire Mbit bit
              for bit, each wall clock its own formula's; (ii) phase async
              (iii)'s configuration with a tick every 2 applications,
              4 applications, every fold's call held in one more;
16. encdec  — (i) whisper-tiny at full width and depth (36,448,128 f32
              params): the prefill (B 2, 1,500 audio frames, decoder S 448)
              card against CPU, and the launcher's audio decode at batch 4
              (tokens/s, ids against the CPU's); it runs no kernel, as the
              reference; (ii) llava-next-34b at full width and 12 of its 60
              layers (7,611,792,384 f32 params): prefill B 2 x S 4096 (576
              patch embeddings and 3,520 tokens) through flash (12
              launches a prefill on ``"wgmma_split"``), the plain path on
              the same batch, ``ServingLoop`` text decode at batch 4, then
              the bf16 prefill (12 launches on ``"wgmma"``, held by
              ``BF16_ANCHOR_FACTOR``). Phase ``kernel`` holds flash at
              llava's prefill shape in f32 and bf16, and phase ``parity``
              reduced whisper-tiny and llava-next-34b. llava's and
              zamba2's weights are drawn on the card (every check of theirs
              compares kernel and plain there);
17. fleet   — the fleet runner (``launch.fleet.run_fleet``, run after phase
              serve_train): FEMNIST at paper width (DNN 200-200, 209,662
              params, U 60, b 32, data from seed 0), K_r-rounds quantized,
              kernel aggregator, 4 rounds, swept over ``fed.k0=64,80`` x
              ``transport.name=none,int8`` with ``share_k_grid``; packed
              (four ``LocalBackend`` slices on four streams), then serial,
              each on a fresh registry: bitwise equal points, programs
              built as the scheduler's plans predict, dispatches a bucket,
              shared counts that add up, exact launches; wall seconds,
              rounds/s and peaks, and the leaderboard CSV under ``build/``;
18. sequential — the mesh's sequential strategy on a one-rank NCCL mesh
              (run after phase fleet, on phase lm's params): (i)
              ``mesh-sequential-cosine.json`` at full width through
              ``launch.train`` for 3 rounds beside the same spec on
              ``backend.name=local`` (K_r, ids, counters exact, params
              within the CPU tests' parity tolerance); (ii) qwen1.5-0.5b,
              32 clients and 16 a round one at a time, int8 up (aggregate
              error feedback) and down, 2 rounds at ``acc_dtype`` f32
              (``int8_decode_apply`` exactly once a leaf a round, one round
              more checked call by call) and one at bf16 on the plain
              uplink, ms a round and a client and the peak over base;
              (iii) CIFAR100 at paper width one round each (mean at
              groups 1 and 5, trimmed_mean + fedavgm) against
              ``LocalBackend``, bitwise or the measured distance.

The line before the last is the kernels summary (``flash_attention``,
``gmm`` and ``ssd_scan`` with their f32 and bf16 rows, paths and launches;
the wire kernels and ``fedavg_reduce`` with their launches in phase
lm_train and their row at qwen's embedding leaf; every entry with its
launches in phase spec, ``spec_launches``, in phases stream and async,
``stream_launches`` and ``async_launches``, in phases serve_train and
encdec, ``serve_train_launches`` and ``encdec_launches``, in phase
fleet's packed run, ``fleet_launches``, and in phase sequential (ii)'s
counted run, ``sequential_launches``);
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


def timed_buckets(torch, fn, log, method: bool = False):
    """Instrumentation of this script only: ``RoundEngine.run_bucket``
    (``fn``; ``method``: the class's function, called with the engine)
    under the host clock between synchronisations. Each dispatch appends
    (ms, its active rounds) to ``log``."""
    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        active = a[5 if method else 4]
        log.append(((time.perf_counter() - t) * 1e3,
                    sum(bool(x) for x in active)))
        return out
    return timed


def per_round_ms(log):
    """Each bucket's ms over its active rounds, once for each of them: the
    ms of every round in order."""
    return [ms / n for ms, n in log for _ in range(n)]


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
        outs = {}
        for dev, eng in engines.items():
            eng.transport_state = to(state["t"], dev)
            eng.downlink_state = to(state["d"], dev)
            p, f, l, s = eng.run_bucket(
                to(state["params"], dev), bb.batches, bb.weights,
                np.full(1, 0.01, np.float32), bb.active, ())
            outs[dev] = (p, f[0], l[0], s)
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

    # instrumentation of this script only: host clock around each bucket,
    # CUDA events around each kernel entry point and each encoder
    buckets, events = [], {}

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
    trainer.engine.run_bucket = timed_buckets(
        torch, trainer.engine.run_bucket, buckets)
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
    round_ms = per_round_ms(buckets)
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
    # bucket (host clock between synchronisations), and a round's ms is its
    # bucket's over the bucket's active rounds; CUDA events around the tree
    # reduce, which span the card's wait for the host's enqueue when the
    # card is idle, and the host clock around the same call
    buckets, reduce_events, reduce_host_ms = [], [], []
    reduce_tree = ops.fedavg_reduce_tree

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

    trainer.engine.run_bucket = timed_buckets(
        torch, trainer.engine.run_bucket, buckets)
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
    round_ms = per_round_ms(buckets)
    bucket_of = [i for i, (_, n) in enumerate(buckets) for _ in range(n)]
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
        bucket_ms, active = buckets[bucket_of[i]]
        emit({"phase": "main", "task": name, "round": h.rounds[i],
              "k": h.k[i], "loss": h.train_loss[i], "ms": round_ms[i],
              "bucket": bucket_of[i], "bucket_ms": bucket_ms,
              "bucket_active_rounds": active,
              "reduce_ms": reduce_ms[i], "reduce_host_ms": reduce_host_ms[i],
              "reduce_share": reduce_ms[i] / round_ms[i]})
    emit({"phase": "main", "task": name, "summary": True,
          "clients_per_round": fed.clients_per_round,
          "batch_size": fed.batch_size, "k": h.k, "eta0": fed.eta0,
          "params": sum(p.numel() for p in tree_leaves(params)),
          "leaves": leaves, "launches": launches,
          "dispatches": trainer.dispatch_count,
          "bucket_programs": trainer.compile_count,
          "ms_per_bucket": [ms for ms, _ in buckets],
          "ms_per_active_round": [ms / n for ms, n in buckets],
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
    # llava-next-34b's attention at its prefill (576 patch positions and
    # 3,520 tokens: S 4096), 56 heads over 8 kv heads (GQA 7:1), hd 128
    ("llava", 2, 56, 8, 4096, 4096, 128, "float32", True, None, None),
    ("llava.bf16", 2, 56, 8, 4096, 4096, 128, "bfloat16", True, None, None),
]
LM_ARCH = "qwen1.5-0.5b"
LM_PARAMS = 463_987_712
LM_BATCH, LM_SEQ = 2, 4096            # train_4k's sequence length
PARITY_ARCHS = ("qwen1.5-0.5b-reduced", "gemma2-27b-reduced",
                "phi3.5-moe-42b-a6.6b-reduced", "mixtral-8x22b-reduced")
PARITY_TOL = dict(rtol=2e-4, atol=2e-4)
ENCDEC_PARITY = ("whisper-tiny-reduced", "llava-next-34b-reduced")
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


def frontend_inputs(torch, cfg, b: int, seed: int):
    """The stub frontends' outputs, on the host: the encoder-decoder's
    (b, encoder_seq, d) audio embeddings, a vlm's (b, patches, d) patch
    embeddings (both N(0, 0.1^2) from ``seed``); nothing for the other
    families."""
    g = torch.Generator().manual_seed(seed)
    if cfg.arch_type == "audio":
        return {"audio_embeds": torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), generator=g) * 0.1}
    if cfg.arch_type == "vlm":
        return {"patch_embeds": torch.randn(
            (b, cfg.num_patch_tokens, cfg.d_model), generator=g) * 0.1}
    return {}


def phase_parity_lm(torch, names=PARITY_ARCHS):
    """Reduced configs (``PARITY_ARCHS``: qwen1.5-0.5b, gemma2-27b,
    phi3.5-moe-42b-a6.6b, mixtral-8x22b; ``SSM_PARITY``; ``ENCDEC_PARITY``:
    whisper-tiny with its audio, llava-next-34b with its patches ahead of
    the tokens): prefill through the kernels on the card against the plain
    path on the CPU (last-token logits, the decode states (KV, or SSM and
    conv; none from the encoder-decoder's step) and, for MoE, every
    layer's routing ids), then 8 greedy decode steps on both (MoE on the
    serving loop's dense path; whisper's cache from one encoder run over
    the same audio; llava text-only), each fed the CPU's token: the card's
    argmax must equal the CPU's wherever the CPU's top-2 logit gap exceeds
    the tolerance."""
    from repro_torch.distributed import make_prefill_step
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves, tree_map
    for name in names:
        cfg = lm_config(name)
        cpu = registry.init(0, cfg, device="cpu")
        card = tree_map(lambda t: t.to("cuda"), cpu)
        toks = torch.tensor(_lm_tokens(cfg, 2, 96, 5))
        extra = frontend_inputs(torch, cfg, 2, 5)
        with torch.no_grad(), RouteLog(torch) as rcpu:
            want = make_prefill_step(cfg, use_kernel=False)(
                cpu, {"tokens": toks, **extra})
        with torch.no_grad(), RouteLog(torch) as rcard:
            got = make_prefill_step(cfg, use_kernel=True)(
                card, {"tokens": toks.cuda(),
                       **{k: v.cuda() for k, v in extra.items()}})
        (want, wst), (got, gst) = ((want, {}), (got, {})) \
            if registry.is_encdec(cfg) else (want, got)
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
        audio = extra.get("audio_embeds")
        with torch.no_grad():
            caches = {dev: registry.init_cache(
                p, cfg, 2, steps, audio_embeds=None if audio is None
                else audio.to(dev)) for dev, p in (("cpu", cpu),
                                                   ("cuda", card))}
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


def lm_batch(torch, cfg, seed):
    """The prefill batch on the card: B ``LM_BATCH`` x S ``LM_SEQ``
    positions from ``seed``; a vlm's patch embeddings take the first
    ``num_patch_tokens`` of them, the tokens the rest."""
    extra = frontend_inputs(torch, cfg, LM_BATCH, seed)
    n_prefix = cfg.num_patch_tokens if "patch_embeds" in extra else 0
    return {"tokens": torch.tensor(_lm_tokens(cfg, LM_BATCH,
                                              LM_SEQ - n_prefix, seed),
                                   device="cuda"),
            **{k: v.cuda() for k, v in extra.items()}}


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
             kernels=(FLASH,), seed=7, state_tol=PARITY_TOL, extra=None,
             cfg=None, gen=None):
    """One architecture at full width (``arch``, ``n_want`` params): prefill
    B 2 x S 4096 through its kernels (each ``(module, short name, layer
    type)``: the wrapper of that name in ``repro_torch.kernels``, one launch
    a layer of that type; the short name names its share), the plain path
    on the same batch (logits within 1e-3, decode states within
    ``state_tol``), then ``ServingLoop`` greedy decode. ``extra(cfg)`` adds
    config fields to the prefill line. Phase ``lm``: qwen1.5-0.5b through
    ``flash_attention``; phase ``ssm``: mamba2-780m through ``ssd_scan``;
    phase ``zamba2``: zamba2-7b through both; phase ``encdec``:
    llava-next-34b (``cfg``, its depth cut) through ``flash_attention``,
    576 patch embeddings ahead of the tokens. The weights come from seed 0
    on ``gen`` (default: a CPU generator, the weights every device gets; a
    CUDA generator draws them on the card, for a phase whose checks stay on
    the card). Returns {module: launches} counted over the four kernel
    prefills, and the f32 params."""
    import importlib
    from repro_torch.configs import get_arch
    from repro_torch.core.engine.model_store import GlobalModelStore
    from repro_torch.core.serve import ServingLoop
    from repro_torch.distributed import make_prefill_step
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves
    mods = {k[0]: importlib.import_module(f"repro_torch.kernels.{k[0]}")
            for k in kernels}
    cfg = cfg or get_arch(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = gen if gen is not None else torch.Generator()
    params = registry.init(gen.manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != n_want or registry.param_count(cfg) != n_want:
        raise AssertionError(f"{arch}: {n_params} params, want {n_want}")
    batch = lm_batch(torch, cfg, seed)

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
          "seq": LM_SEQ, "init_s": init_s, "init_device": gen.device.type,
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
    batch = lm_batch(torch, cfg, seed)
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

    # instrumentation of this script only: host clock around each bucket,
    # CUDA events around each all-reduce
    buckets, events = [], []
    all_reduce = dist.all_reduce

    def timed_all_reduce(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = all_reduce(*a, **kw)
        ev[1].record()
        events.append(ev)
        return out

    trainer.engine.run_bucket = timed_buckets(
        torch, trainer.engine.run_bucket, buckets)
    dist.all_reduce = timed_all_reduce
    try:
        h = trainer.run(rounds)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    ar_ms = sum(a.elapsed_time(b) for a, b in events) / rounds
    return trainer, h, per_round_ms(buckets), ar_ms, len(events)


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


def lm_train_want(fed, sizes, rounds: int, stretch: float = 1.0,
                  qps=None):
    """K_r and the cumulative History counters the RuntimeModel formula
    (Eq. 3, homogeneous clients, the default 20 / 5 Mbit/s links) gives,
    computed here from the leaf sizes: |x| is the params at 4 bytes, and
    each leg's Mbit is |x| over the codec's ratio (full bits over the
    encoded bits: int8 a byte a value and a scale a leaf, top-k a value
    and an index a kept coordinate). Serving while training multiplies
    each round's wall clock by ``stretch`` = 1/(1 - rho); with ``qps`` the
    cumulative ``serve_queries`` (qps x each round's wall) come too."""
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
    wall, steps, up_t, down_t, queries = 0.0, 0, 0.0, 0.0, 0.0
    for k in ks:
        w = (down / 20.0 + k * BETA + up / 5.0) * stretch
        wall += w
        if qps is not None:
            queries += qps * w
            want.setdefault("serve_queries", []).append(queries)
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
    model. Returns, for each kernel that ran, its calls, leaf sizes, client
    rows, max abs error and tolerance."""
    h, seen = check_calls(torch, lambda: trainer.run(1), label)
    if not math.isfinite(h.train_loss[-1]):
        raise AssertionError(f"lm_train ({label}): checked round's loss "
                             f"{h.train_loss[-1]}")
    return seen


def check_calls(torch, run, label):
    """``run()`` with each call of a wire entry point and of the tree
    reduce held against its plain version on the same inputs. Returns
    ``(run's result, {kernel: calls, leaf sizes "m", client rows "n" (1
    for an apply), max abs error, tolerance})``; the tree reduce's entry
    also holds the weights "w" of each call, on the host."""
    from repro_torch.kernels import ops, ref
    from repro_torch.optim import tree_leaves
    plain = {"int8_decompress_reduce": (ref.int8_decompress_reduce_ref,
                                        REDUCE_TOL),
             "int8_decode_apply": (ref.int8_decode_apply_ref, "exact"),
             "topk_scatter_reduce": (ref.topk_scatter_reduce_ref, "exact"),
             "topk_scatter_apply": (ref.topk_scatter_apply_ref, "exact")}
    seen = {}

    def note(key, ms, rows, err, tol):
        r = seen.setdefault(key, {"calls": 0, "m": [], "n": [],
                                  "max_abs_err": 0.0, "tol": tol})
        r["calls"] += 1
        r["m"] += ms
        r["n"].append(rows)
        r["max_abs_err"] = max(r["max_abs_err"], err)

    def checked(key, fn):
        want_fn, tol = plain[key]

        def call(*a):
            out = fn(*a)
            err = _check(torch, out, want_fn(*a), tol,
                         f"lm_train ({label}) {key} at M {out.numel()}")
            rows = int(a[0].shape[0]) if key.endswith("reduce") else 1
            note(key, [out.numel()], rows, err, tol)
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
            note("fedavg_reduce", ms, int(w.shape[0]), err, TOL["float32"])
            seen["fedavg_reduce"].setdefault("w", []).append(w.cpu())
            return out
        return call

    saved = {fn: getattr(ops, fn) for fn in WIRE_ENTRIES.values()}
    saved["fedavg_reduce_tree"] = ops.fedavg_reduce_tree
    for key, fn in WIRE_ENTRIES.items():
        setattr(ops, fn, checked(key, saved[fn]))
    ops.fedavg_reduce_tree = checked_tree(saved["fedavg_reduce_tree"])
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for fn, f in saved.items():
            setattr(ops, fn, f)
    return out, seen


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

    # instrumentation of this script only: host clock around each bucket,
    # CUDA events around the vmapped client update (its K local steps),
    # each kernel entry point, each encoder and the tree reduce
    events = {}

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
    buckets = []
    trainer.engine.run_bucket = timed_buckets(
        torch, trainer.engine.run_bucket, buckets)
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
    round_ms = per_round_ms(buckets)

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
    # no codec: the state is (), a leaf of no tensor
    ef = [t for t in tree_leaves(trainer.engine.transport_state)
          if isinstance(t, torch.Tensor)]
    ef_shape = list(ef[0].shape[:1]) if ef else None
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


# ---------------------------------------------------------------------------
# the spec-driven entry point (phase 12)
# ---------------------------------------------------------------------------

SPEC_DIR = Path(__file__).resolve().parent / "examples" / "specs"
# (i): rounds through the launcher before the checkpoint, and the round the
# restored run continues to
SPEC_SAVE_AT, SPEC_RESUME_TO = 2, 4
# (iii): fixed-cohort-topk, reduced, saved after 2 of 3 rounds
TOPK_SAVE_AT, TOPK_ROUNDS = 2, 3
# (iv): CIFAR100 at its paper FedConfig (phase main's), as a spec
CIFAR_SPEC = {
    "data": {"kind": "paper", "task": "cifar100", "clients": 100,
             "samples_per_client": 100, "seed": 0},
    "fed": {"rounds": 2, "clients_per_round": 25, "k0": 50, "eta0": 0.01,
            "batch_size": 32, "k_schedule": "rounds",
            "aggregator": "kernel"},
    "runtime": {"beta_seconds": 0.31}}
SPEC_COUNTERS = ("rounds", "k", "eta", "sgd_steps", "wall_clock_s",
                 "uplink_mbit", "downlink_mbit")


def _quiet(fn, *a):
    """``fn(*a)`` with its standard output kept: (result, text)."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a)
    return res, out.getvalue()


def _host(tree):
    """{checkpoint key: numpy array} of a tensor tree, copied to the
    host."""
    return {k.lstrip(".").replace(".", "/"): t.detach().cpu().numpy()
            for k, t in leaf_items(tree, "")}


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def _max_diff(a, b) -> float:
    import numpy as np
    if sorted(a) != sorted(b):
        raise AssertionError(f"trees differ in keys: {sorted(a)[:3]} vs "
                             f"{sorted(b)[:3]}")
    return max(float(np.max(np.abs(a[k] - b[k]))) if a[k].size else 0.0
               for k in a)


def _recorded_ids():
    """Instrumentation of this script only: every trainer built until
    ``undo()`` records the client ids its sampler draws, in one list."""
    from repro_torch.core.engine import trainer as trainer_mod
    ids, make = [], trainer_mod.make_sampler

    def make_recorded(fed):
        sampler = make(fed)
        draw = sampler.round

        def round_(*a, **kw):
            out = draw(*a, **kw)
            ids.append([int(c) for c in out[0]])
            return out

        sampler.round = round_
        return sampler

    trainer_mod.make_sampler = make_recorded
    return ids, lambda: setattr(trainer_mod, "make_sampler", make)


def _split_vs_straight(torch, label, spec, save_at, total, tmp, launcher,
                       check=False):
    """Run ``spec`` to ``save_at`` and save (through ``launch.train`` when
    ``launcher``, else ``build``), restore and resume to ``total``; then
    ``build(spec).run(total)`` twice. One trainer lives at a time; the
    params go to the host between runs. With ``check``, the resumed
    trainer runs one round more after its counts and params were read,
    each kernel call held against its plain version (``check_lm_round``).
    Returns the runs' histories, ids, host params, per-run launch counts,
    timings, the checked round and the checkpoint path."""
    from repro_torch.api import FederatedExperiment, build
    from repro_torch.core.engine import round as round_mod
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.launch import train
    ckpt = os.path.join(tmp, label)
    ids, undo = _recorded_ids()
    # instrumentation of this script only: host clock around each bucket
    # (synchronised), and around the save and the restore
    buckets, run_bucket = [], round_mod.RoundEngine.run_bucket

    from repro_torch.core.engine.trainer import FedAvgTrainer
    save, save_s = FederatedExperiment.save, []
    restore_state, load_s = FedAvgTrainer.restore_state, []

    def timed(fn, out):
        def call(self, path):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(self, path)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return call

    round_mod.RoundEngine.run_bucket = timed_buckets(torch, run_bucket,
                                                     buckets, method=True)
    FederatedExperiment.save = timed(save, save_s)
    FedAvgTrainer.restore_state = timed(restore_state, load_s)
    runs, counts = {}, {}

    def count():
        return {**dc.launches, "fedavg_reduce": fr.launches}

    def zero():
        for k in dc.launches:
            dc.launches[k] = 0
        fr.launches = 0

    try:
        torch.cuda.reset_peak_memory_stats()
        zero()
        if launcher:
            spec_path = os.path.join(tmp, f"{label}.json")
            spec.with_overrides(f"fed.rounds={save_at}").save(spec_path)
            exp, out = _quiet(train.main, ["--spec", spec_path,
                                           "--checkpoint", ckpt])
            if f"[train] checkpoint (spec embedded) -> {ckpt}" not in out:
                raise AssertionError(f"spec ({label}): the launcher did not "
                                     f"report its checkpoint:\n{out}")
        else:
            exp = build(spec.with_overrides(f"fed.rounds={save_at}"))
            exp.run()
            exp.save(ckpt)
        counts["first"] = count()
        first_h = exp.history.as_dict()
        n_first = len(buckets)
        del exp
        _free(torch)
        zero()
        torch.cuda.synchronize()
        t = time.perf_counter()
        exp = FederatedExperiment.restore(ckpt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        exp.trainer.run(total, resume=True)
        counts["resumed"] = count()
        slots = [list(t.shape) for _, t in leaf_items(
            exp.trainer.engine.transport_state, "")
            if isinstance(t, torch.Tensor)]
        runs["resumed"] = (exp.history.as_dict(), _host(exp.params),
                           {"slots": slots, "fed": exp.trainer.fed})
        checked, n_ids, n_buckets = None, len(ids), len(buckets)
        if check:
            checked = check_lm_round(torch, exp.trainer, f"spec {label}")
            del ids[n_ids:], buckets[n_buckets:]
        del exp
        _free(torch)
        for rep in ("straight", "repeat"):
            zero()
            exp = build(spec.with_overrides(f"fed.rounds={total}"))
            exp.run()
            counts[rep] = count()
            runs[rep] = (exp.history.as_dict(), _host(exp.params), None)
            del exp
            _free(torch)
    finally:
        undo()
        round_mod.RoundEngine.run_bucket = run_bucket
        FederatedExperiment.save = save
        FedAvgTrainer.restore_state = restore_state
    return {"runs": runs, "ids": ids, "counts": counts, "checked": checked,
            "first": first_h,
            "first_ms": per_round_ms(buckets[:n_first]),
            "round_ms": per_round_ms(buckets[n_first:]),
            "save_s": save_s[0], "load_s": load_s[0],
            "restore_s": restore_s, "ckpt": ckpt,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _hold_resume(label, r, save_at, total):
    """The repeat rule: if two uninterrupted runs are bitwise equal, the
    resumed run must equal them bitwise; else it must lie within the
    repeat's difference. Counters and client ids exact either way."""
    (rh, rp, _), (sh, sp, _), (ph, pp, _) = (
        r["runs"]["resumed"], r["runs"]["straight"], r["runs"]["repeat"])
    ids = r["ids"]
    # ids: first run, resumed rounds, straight, repeat
    n_first, n_res = save_at, total - save_at
    first, resumed = ids[:n_first], ids[n_first:n_first + n_res]
    straight = ids[n_first + n_res:n_first + n_res + total]
    repeat = ids[n_first + n_res + total:]
    if first + resumed != straight or straight != repeat:
        raise AssertionError(f"spec ({label}): client ids {ids}")
    for key in SPEC_COUNTERS:
        if not (rh[key] == sh[key] == ph[key]):
            raise AssertionError(f"spec ({label}): {key} {rh[key]} vs "
                                 f"{sh[key]} vs {ph[key]}")
    if rh["rounds"] != list(range(1, total + 1)) or \
            r["first"]["rounds"] != list(range(1, save_at + 1)):
        raise AssertionError(f"spec ({label}): rounds {rh['rounds']}")
    repeat_diff = _max_diff(sp, pp)
    resume_diff = _max_diff(rp, sp)
    loss_repeat = max(abs(a - b) for a, b in zip(sh["train_loss"],
                                                 ph["train_loss"]))
    loss_resume = max(abs(a - b) for a, b in zip(rh["train_loss"],
                                                 sh["train_loss"]))
    bitwise = repeat_diff == 0.0 and loss_repeat == 0.0
    if bitwise and (resume_diff != 0.0 or loss_resume != 0.0):
        raise AssertionError(f"spec ({label}): the repeat is bitwise but "
                             f"the resume is {resume_diff} (params), "
                             f"{loss_resume} (loss) off")
    if resume_diff > repeat_diff or loss_resume > loss_repeat:
        raise AssertionError(f"spec ({label}): resume {resume_diff} "
                             f"(params), {loss_resume} (loss) off, beyond "
                             f"the repeat's {repeat_diff}, {loss_repeat}")
    if not all(math.isfinite(v) for v in rh["train_loss"]):
        raise AssertionError(f"spec ({label}): loss {rh['train_loss']}")
    return {"repeat_bitwise": bitwise,
            "repeat_max_abs_diff": repeat_diff,
            "resume_max_abs_diff": resume_diff,
            "repeat_loss_diff": loss_repeat,
            "resume_loss_diff": loss_resume}


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_spec(torch):
    """The spec-driven entry point (``repro_torch.api``, the launchers):
    (i) ``local-int8-decayK`` at full width through ``launch.train``,
    checkpointed after 2 rounds, restored and resumed to 4, held to two
    uninterrupted runs; (ii) ``launch.serve --checkpoint`` on that
    checkpoint; (iii) reduced ``fixed-cohort-topk`` through ``build``,
    saved after 2 of 3 rounds (its per-client residual slots restored);
    (iv) a CIFAR100 spec with the kernel aggregator through the launcher;
    (v) the quickstart. Returns each kernel's launches over the phase."""
    import tempfile

    import numpy as np
    from repro_torch.api import ExperimentSpec
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.launch import quickstart, serve, train
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves
    total = dict.fromkeys(list(dc.launches) + ["fedavg_reduce"], 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # (i) qwen1.5-0.5b at full width through the launcher
        spec = ExperimentSpec.load(str(SPEC_DIR / "local-int8-decayK.json")
                                   ).with_overrides("model.reduced=false")
        from repro_torch.configs import get_arch
        cfg = get_arch(spec.model.arch)
        n_params = registry.param_count(cfg)
        if n_params != LM_PARAMS:
            raise AssertionError(f"spec (i): {n_params} params, want "
                                 f"{LM_PARAMS}")
        t0 = time.perf_counter()
        r = _split_vs_straight(torch, "i", spec, SPEC_SAVE_AT,
                               SPEC_RESUME_TO, tmp, launcher=True)
        held = _hold_resume("i", r, SPEC_SAVE_AT, SPEC_RESUME_TO)
        leaves = len(r["runs"]["straight"][1])
        want = {"first": SPEC_SAVE_AT, "resumed": SPEC_RESUME_TO
                - SPEC_SAVE_AT, "straight": SPEC_RESUME_TO,
                "repeat": SPEC_RESUME_TO}
        for run, n in want.items():
            got = r["counts"][run]
            if got["int8_decompress_reduce"] != n * leaves or any(
                    v for k, v in got.items()
                    if k != "int8_decompress_reduce"):
                raise AssertionError(f"spec (i) {run}: launches {got}, want "
                                     f"{n * leaves} int8_decompress_reduce")
            add(got)
        sizes = [int(a.size) for a in r["runs"]["straight"][1].values()]
        fed = r["runs"]["resumed"][2]["fed"]
        formula = lm_train_want(fed, sizes, SPEC_RESUME_TO)
        got = {k: r["runs"]["resumed"][0][k] for k in formula}
        if got != formula:
            raise AssertionError(f"spec (i): counters {got} != the "
                                 f"RuntimeModel formula's {formula}")
        ckpt_bytes = _dir_bytes(r["ckpt"])
        emit({"phase": "spec", "what": "(i) local-int8-decayK, full width, "
              "launch.train -> checkpoint -> restore -> resume",
              "arch": cfg.name, "params": n_params, "leaves": leaves,
              "saved_after": SPEC_SAVE_AT, "resumed_to": SPEC_RESUME_TO,
              "k": r["runs"]["resumed"][0]["k"],
              "loss": r["runs"]["resumed"][0]["train_loss"],
              "ids": r["ids"][:SPEC_RESUME_TO],
              "counters_exact": True, **held,
              "ms_per_round": sum(r["round_ms"]) / len(r["round_ms"]),
              "ms_launcher_rounds": r["first_ms"],
              "checkpoint_bytes": ckpt_bytes, "save_s": r["save_s"],
              "restore_state_s": r["load_s"],
              "restore_with_build_s": r["restore_s"],
              "peak_mem_gb": r["peak_mem_gb"],
              "int8_decompress_reduce_launches": {
                  k: v["int8_decompress_reduce"]
                  for k, v in r["counts"].items()},
              "s": time.perf_counter() - t0})
        del r
        _free(torch)

        # (ii) serve that checkpoint: the served params are the saved ones
        ckpt = os.path.join(tmp, "i")
        t0 = time.perf_counter()
        res, out = _quiet(serve.main, ["--checkpoint", ckpt])
        served = _host(res["params"])
        with np.load(os.path.join(ckpt, "arrays.npz")) as data:
            saved_keys = sorted(k[len("params/"):] for k in data
                                if k.startswith("params/"))
            if sorted(served) != saved_keys:
                raise AssertionError(f"spec (ii): served keys "
                                     f"{sorted(served)[:4]} vs "
                                     f"{saved_keys[:4]}")
            for k, v in served.items():
                if not np.array_equal(v, data["params/" + k]):
                    raise AssertionError(f"spec (ii): served {k} differs "
                                         f"from the checkpoint")
        ids = res["ids"]
        if tuple(ids.shape) != (SERVE["batch"], SERVE["tokens"]):
            raise AssertionError(f"spec (ii): ids {tuple(ids.shape)}")
        emit({"phase": "spec", "what": "(ii) launch.serve --checkpoint",
              "arch": res["cfg"].name, "params_bitwise": True,
              "batch": SERVE["batch"], "tokens": SERVE["tokens"],
              "tokens_per_s": res["tokens_per_s"],
              "ids0": [int(x) for x in ids[0][:8]],
              "s": time.perf_counter() - t0})
        del res, served
        _free(torch)

        # (iii) reduced fixed-cohort-topk: the residual slots survive
        t0 = time.perf_counter()
        spec = ExperimentSpec.load(str(SPEC_DIR / "fixed-cohort-topk.json"))
        r = _split_vs_straight(torch, "iii", spec, TOPK_SAVE_AT, TOPK_ROUNDS,
                               tmp, launcher=False, check=True)
        held = _hold_resume("iii", r, TOPK_SAVE_AT, TOPK_ROUNDS)
        slots = r["runs"]["resumed"][2]["slots"]
        if not slots or any(s[0] != spec.fed.clients_per_round
                            for s in slots):
            raise AssertionError(f"spec (iii): residual slots {slots}")
        leaves = len(r["runs"]["straight"][1])
        want = {"first": TOPK_SAVE_AT, "resumed": TOPK_ROUNDS - TOPK_SAVE_AT,
                "straight": TOPK_ROUNDS, "repeat": TOPK_ROUNDS}
        for run, n in want.items():
            got = r["counts"][run]
            if got["topk_scatter_reduce"] != n * leaves or any(
                    v for k, v in got.items() if k != "topk_scatter_reduce"):
                raise AssertionError(f"spec (iii) {run}: launches {got}")
            add(got)
        # the resumed trainer's checked round: each leaf's top-k reduce at
        # the reduced sizes equals its plain version exactly
        sizes = sorted(int(a.size) for a in r["runs"]["straight"][1].values())
        checked = r["checked"]
        if set(checked) != {"topk_scatter_reduce"} or sorted(
                checked["topk_scatter_reduce"]["m"]) != sizes:
            raise AssertionError(f"spec (iii): checked round ran {checked}, "
                                 f"want topk_scatter_reduce at {sizes}")
        emit({"phase": "spec", "what": "(iii) fixed-cohort-topk, reduced, "
              "build -> checkpoint -> restore -> resume",
              "ef_slots": slots[0][0], "leaves": leaves,
              "k": r["runs"]["resumed"][0]["k"],
              "ids": r["ids"][:TOPK_ROUNDS], **held,
              "checked_round": {k: {"calls": v["calls"],
                                    "leaves": len(v["m"]),
                                    "max_abs_err": v["max_abs_err"],
                                    "tol": v["tol"]}
                                for k, v in checked.items()},
              "checkpoint_bytes": _dir_bytes(r["ckpt"]),
              "topk_scatter_reduce_launches": {
                  k: v["topk_scatter_reduce"]
                  for k, v in r["counts"].items()},
              "s": time.perf_counter() - t0})
        del r
        _free(torch)

        # (iv) CIFAR100 at paper width through the launcher
        t0 = time.perf_counter()
        path = os.path.join(tmp, "cifar100.json")
        with open(path, "w") as f:
            json.dump(CIFAR_SPEC, f)
        for k in dc.launches:
            dc.launches[k] = 0
        fr.launches = 0
        exp, out = _quiet(train.main, ["--spec", path])
        counts = {**dc.launches, "fedavg_reduce": fr.launches}
        h = exp.history
        rounds = CIFAR_SPEC["fed"]["rounds"]
        if counts["fedavg_reduce"] != rounds or any(
                v for k, v in counts.items() if k != "fedavg_reduce"):
            raise AssertionError(f"spec (iv): launches {counts}, want "
                                 f"{rounds} fedavg_reduce")
        want_k = [min(max(math.ceil(50 / r_ ** (1.0 / 3.0)), 1), 50)
                  for r_ in range(1, rounds + 1)]
        if h.k != want_k or not all(math.isfinite(v)
                                     for v in h.train_loss):
            raise AssertionError(f"spec (iv): K {h.k}, loss "
                                 f"{h.train_loss}")
        add(counts)
        emit({"phase": "spec", "what": "(iv) CIFAR100 spec, kernel "
              "aggregator, launch.train", "k": h.k, "loss": h.train_loss,
              "params": sum(t.numel() for t in tree_leaves(exp.params)),
              "launches": counts["fedavg_reduce"],
              "sgd_steps": h.sgd_steps, "wall_clock_s": h.wall_clock_s,
              "s": time.perf_counter() - t0})
        del exp
        _free(torch)

    # (v) the quickstart
    t0 = time.perf_counter()
    for k in dc.launches:
        dc.launches[k] = 0
    fr.launches = 0
    res, out = _quiet(quickstart.main, ["--rounds", "10"])
    f, d = res["fixed"], res["rounds"]
    want_k = [min(max(math.ceil(16 / r_ ** (1.0 / 3.0)), 1), 16)
              for r_ in range(1, 11)]
    if f.k != [16] * 10 or d.k != want_k or f.sgd_steps[-1] != 1600 \
            or d.sgd_steps[-1] != 10 * sum(want_k):
        raise AssertionError(f"spec (v): K {f.k}, {d.k}")
    if not all(math.isfinite(v) for v in f.train_loss + d.train_loss):
        raise AssertionError("spec (v): non-finite loss")
    summary = [ln for ln in out.splitlines()
               if ln.startswith(("fixed-K", "K-decay", "compute saved"))]
    emit({"phase": "spec", "what": "(v) launch.quickstart --rounds 10",
          "summary": summary, "k_decay": d.k,
          "wall_clock_s": [f.wall_clock_s[-1], d.wall_clock_s[-1]],
          "s": time.perf_counter() - t0})
    emit({"phase": "spec", "summary": True, "launches": total,
          "s": time.perf_counter() - t_phase})
    return total


# ---------------------------------------------------------------------------
# streaming cohorts and async buffered aggregation (phases 13 and 14)
# ---------------------------------------------------------------------------

STREAM_ROUNDS = 2
# (i): CIFAR100 dense, one slab of the whole cohort, and slabs of 3 (eight
# of 3 and a tail of 1). vmap's batch count changes the cuDNN and cuBLAS
# algorithms and 90 local steps amplify the difference at a few entries
# (2.9e-4 at 2 of fc2's 51,200, 6% of the leaf's movement, where the f32
# tolerance alone allows 2e-4), so C = 3 holds dense at tests/
# test_kernels.py's f32 tolerance plus STREAM_MOVE of each leaf's movement
# over the run (max |dense - init|) entry by entry, and its mean |C=3 -
# dense| within STREAM_MOVE_MEAN of that movement leaf by leaf
STREAM_CHUNKS = (None, 25, 3)
STREAM_TOL = dict(rtol=2e-4, atol=2e-4)
STREAM_MOVE, STREAM_MOVE_MEAN = 0.1, 0.01
# (ii): qwen1.5-0.5b, the LM specs' traffic (lm_train (a)) at 32 clients,
# 16 a round in slabs of 4
LM_STREAM = dict(total_clients=32, clients_per_round=16, cohort_chunk=4)
# async (iii): 12 clients, 4 in flight, a buffer of 2
LM_ASYNC = dict(aggregation="async", buffer_size=2, staleness_weight="inv",
                max_staleness=4)
LM_ASYNC_HET, LM_ASYNC_APPLIES = 0.8, 4
# async (i): the checkpoint after this many applications
ASYNC_SAVE_AT = 4
# async (ii): tests/test_async.py's base spec
ORACLE = ("data.kind=paper", "data.task=femnist", "data.clients=16",
          "fed.clients_per_round=8", "fed.rounds=6", "fed.k0=4",
          "fed.batch_size=8", "fed.eval_every=0", "fed.k_schedule=rounds")


def kernel_counts():
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    return {**dc.launches, "fedavg_reduce": fr.launches}


def zero_counts():
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import fedavg_reduce as fr
    for k in dc.launches:
        dc.launches[k] = 0
    fr.launches = 0


def only(counts, want, what):
    """The counts are ``want`` and zero for every other kernel."""
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        raise AssertionError(f"{what}: launches {counts}, want {full}")


def timed_rounds(torch, engine):
    """Instrumentation of this script only: the host ms of each round an
    engine runs, synchronised before and after each dispatch: a streamed
    round's, or a dense bucket's over its active rounds for each of
    them."""
    ms, buckets = [], []
    bucket = timed_buckets(torch, engine.run_bucket, buckets)
    chunked = engine.run_round_chunked

    def timed_bucket(*a):
        out = bucket(*a)
        ms.extend(per_round_ms(buckets[-1:]))
        return out

    def timed_chunked(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = chunked(*a)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        return out

    engine.run_bucket, engine.run_round_chunked = timed_bucket, timed_chunked
    return ms


def _bitwise(a, b) -> bool:
    """Two host trees (``_host``) equal value for value (-0.0 == 0.0)."""
    import numpy as np
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)


def _peak_run(torch, make, run):
    """``make()`` then ``run(made)`` with the allocator's peak reset just
    before and every count zeroed: (made, run's result, the counts, the
    peak GB over what was allocated before, the peak GB, seconds). The
    peak is ``core.trainer_peak_mb`` of the made trainer."""
    from repro_torch.core import trainer_peak_mb
    _free(torch)
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    made = make()
    t0 = time.perf_counter()
    out = run(made)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    peak = trainer_peak_mb(made) / 1e3
    return made, out, kernel_counts(), peak - base, peak, s


def _cifar_trainer(torch, task, data, chunk):
    """(i)'s trainer: CIFAR100 at paper width (U 25, b 32, K0 50, eta0
    0.01, K_r-rounds, the kernel aggregator) in slabs of ``chunk`` (None:
    dense), its rounds timed (``timed_rounds``, in ``_ms``)."""
    from repro_torch.core import FedAvgTrainer, RuntimeModel
    from repro_torch.models import small
    fed = dataclasses.replace(task.fed, k_schedule="rounds",
                              aggregator="kernel", rounds=STREAM_ROUNDS,
                              cohort_chunk=chunk)
    tr = FedAvgTrainer(lambda p, b: small.task_loss(p, task, b),
                       small.init_task_model(0, task), data, fed,
                       RuntimeModel(task.model_size_mb, task.runtime,
                                    fed.clients_per_round))
    tr._ms = timed_rounds(torch, tr.engine)
    return tr


def slab_rows(u, chunk):
    """The client rows of each slab of a round of ``u`` in slabs of
    ``chunk`` (None: one of ``u``)."""
    c = chunk or u
    return [min(c, u - s) for s in range(0, u, c)]


def c3_shares(pd, p3, init):
    """How far the C = 3 params ``p3`` are from dense ``pd`` (host trees,
    both started from ``init``), against (i)'s bound: the worst entry's
    share of the f32 tolerance plus ``STREAM_MOVE`` of its leaf's
    movement, and the worst leaf's mean |C=3 - dense| as a share of
    ``STREAM_MOVE_MEAN`` of that movement. The check is both at most 1."""
    import numpy as np
    worst = worst_mean = 0.0
    for k in pd:
        move = float(np.max(np.abs(pd[k] - init[k])))
        diff = np.abs(p3[k] - pd[k])
        bound = (STREAM_TOL["atol"] + STREAM_TOL["rtol"] * np.abs(pd[k])
                 + STREAM_MOVE * move)
        worst = max(worst, float(np.max(diff / bound)))
        worst_mean = max(worst_mean,
                         float(np.mean(diff)) / (STREAM_MOVE_MEAN * move))
    return worst, worst_mean


def _checked_cifar(torch, task, data, chunk, label):
    """(i)'s trainer in slabs of ``chunk`` run through ``check_calls``:
    (its host params, its tree reduce's calls, each round's slab weights
    joined)."""
    tr = _cifar_trainer(torch, task, data, chunk)
    _, seen = check_calls(torch, lambda: tr.run(STREAM_ROUNDS), label)
    red = seen.get("fedavg_reduce", {})
    rows = slab_rows(tr.fed.clients_per_round, chunk)
    if set(seen) != {"fedavg_reduce"} or red["n"] != rows * STREAM_ROUNDS:
        raise AssertionError(f"{label}: checked run ran {seen}")
    n = len(rows)
    weights = [torch.cat(red["w"][i * n:(i + 1) * n])
               for i in range(STREAM_ROUNDS)]
    params = _host(tr.params)
    del tr
    _free(torch)
    return params, red, weights


def _tail_dropped(torch, task, data):
    """(i)'s negative control: ``_checked_cifar`` at C = 3 with the engine
    placing the one-client tail slab at weight 0 (a dropped client)."""
    from repro_torch.core.engine.backends.local import LocalBackend
    had = LocalBackend.__dict__.get("place_slab")
    place = LocalBackend.place_slab

    def dropped(self, sb):
        if sb.stop - sb.start == 1:
            sb = dataclasses.replace(sb, weights=sb.weights * 0)
        return place(self, sb)

    LocalBackend.place_slab = dropped
    try:
        return _checked_cifar(torch, task, data, 3, "stream (i) control")
    finally:
        if had is None:
            del LocalBackend.place_slab
        else:
            LocalBackend.place_slab = had


def stream_cifar(torch, data):
    """(i) CIFAR100 at paper width (``_cifar_trainer``, cuDNN
    deterministic) for ``STREAM_ROUNDS`` rounds dense, as one slab of 25,
    and in slabs of 3. Each run is measured, then repeated with every
    ``fedavg_reduce`` call held against its plain version: the repeat must
    give the measured run's params bit for bit, its calls the slabs' rows,
    and each round's slab weights, joined, the dense round's weights. A
    negative control (``_tail_dropped``) must fail that weight check and
    the C = 3 bound. Returns the launches."""
    from repro_torch.configs import get_paper_task
    from repro_torch.models import small
    task = get_paper_task("cifar100")
    u = task.fed.clients_per_round
    total, runs, checked, weights = {}, {}, {}, {}
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for chunk in STREAM_CHUNKS:
            label = f"stream (i) C={chunk}"
            tr, h, counts, peak, _, _ = _peak_run(
                torch, lambda: _cifar_trainer(torch, task, data, chunk),
                lambda t: t.run(STREAM_ROUNDS))
            rows = slab_rows(u, chunk)
            only(counts, {"fedavg_reduce": STREAM_ROUNDS * len(rows)}, label)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            runs[chunk] = (h.as_dict(), _host(tr.params), peak, tr._ms)
            del tr
            _free(torch)
            params, red, weights[chunk] = _checked_cifar(torch, task, data,
                                                         chunk, label)
            if not _bitwise(params, runs[chunk][1]):
                raise AssertionError(f"{label}: the checked run is not the "
                                     f"measured one")
            checked[chunk] = {"calls": red["calls"],
                              "rows": sorted(set(red["n"])),
                              "max_abs_err": red["max_abs_err"],
                              "tol": red["tol"]}
        p_ctrl, _, w_ctrl = _tail_dropped(torch, task, data)
    finally:
        torch.backends.cudnn.deterministic = old
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    for chunk in (25, 3):
        if not same(weights[chunk], weights[None]):
            raise AssertionError(f"stream (i) C={chunk}: the slab weights "
                                 f"are not the dense round's")
    if same(w_ctrl, weights[None]):
        raise AssertionError("stream (i): the slab-weight check passed a "
                             "run that dropped the tail client")
    (hd, pd, peak_d, ms_d) = runs[None]
    (hu, pu, peak_u, ms_u) = runs[25]
    (h3, p3, peak_3, ms_3) = runs[3]
    if not _bitwise(pu, pd) or hu["train_loss"] != hd["train_loss"]:
        raise AssertionError(f"stream (i): one slab of 25 is not the dense "
                             f"round: {_max_diff(pu, pd)}")
    init = _host(small.init_task_model(0, task))
    worst, worst_mean = c3_shares(pd, p3, init)
    ctrl_worst, ctrl_mean = c3_shares(pd, p_ctrl, init)
    if ctrl_worst <= 1.0 and ctrl_mean <= 1.0:
        raise AssertionError(f"stream (i): the C = 3 bound passed a run that "
                             f"dropped the tail client ({ctrl_worst}, "
                             f"{ctrl_mean})")
    if worst > 1.0 or worst_mean > 1.0:
        raise AssertionError(f"stream (i) C=3: {worst} of the entry bound, "
                             f"{worst_mean} of the leaf mean bound")
    import numpy as np
    np.testing.assert_allclose(h3["train_loss"], hd["train_loss"],
                               **STREAM_TOL)
    if any(h[key] != hd[key] for h in (hu, h3) for key in SPEC_COUNTERS):
        raise AssertionError("stream (i): counters differ")
    ratio = peak_d / peak_3
    if ratio < 4.0:
        raise AssertionError(f"stream (i): peak dense {peak_d} GB over "
                             f"C=3 {peak_3} GB is {ratio}, under 4x")
    emit({"phase": "stream", "what": "(i) CIFAR100 paper width, kernel "
          "aggregator, dense / C=25 / C=3", "k": hd["k"],
          "loss": {"dense": hd["train_loss"], "c25": hu["train_loss"],
                   "c3": h3["train_loss"]},
          "ms_per_round": {"dense": ms_d, "c25": ms_u, "c3": ms_3},
          "peak_gb_over_base": {"dense": peak_d, "c25": peak_u,
                                "c3": peak_3},
          "peak_ratio_dense_over_c3": ratio, "c25_bitwise": True,
          "c3_max_abs_diff": _max_diff(p3, pd),
          "c3_tol": {**STREAM_TOL, "move": STREAM_MOVE,
                     "mean_move": STREAM_MOVE_MEAN},
          "c3_worst_share_of_tol": worst,
          "c3_worst_mean_share": worst_mean,
          "fedavg_reduce_launches": {
              str(c or "dense"): STREAM_ROUNDS * len(slab_rows(u, c))
              for c in STREAM_CHUNKS},
          "checked_runs": {str(c or "dense"): v for c, v in checked.items()},
          "slab_weights_equal_dense": True,
          "control_tail_dropped": {
              "slab_weights_equal_dense": False,
              "max_abs_diff": _max_diff(p_ctrl, pd),
              "worst_share_of_tol": ctrl_worst,
              "worst_mean_share": ctrl_mean},
          "cudnn_deterministic": True})
    return total


def _lm_fed(**kw):
    """The LM specs' traffic (``lm_train_timing.TRAFFIC``, configuration
    (a): int8 uplink, k0 8) with ``kw`` over it."""
    from repro_torch.configs import FedConfig
    from repro_torch.launch.lm_train_timing import CONFIGS, TRAFFIC
    return FedConfig(**{**TRAFFIC, **CONFIGS["a"], **kw})


def _lm_engine(cfg, params, data, fed, het=0.0, backend=None):
    """``build``'s trainer for ``fed`` (``AGGREGATION_REGISTRY``: a
    ``FedAvgTrainer`` or an ``AsyncBufferedEngine``) on the LM loss, |x|
    the params at 4 bytes, beta 0.05 s; ``backend`` (default local)."""
    from repro_torch.api.registries import AGGREGATION_REGISTRY
    from repro_torch.configs.base import RuntimeModelConfig
    from repro_torch.core import RuntimeModel
    from repro_torch.launch.lm_train_timing import BETA
    from repro_torch.models import registry
    model_loss = registry.loss_fn(cfg)
    rt = RuntimeModel(registry.param_count(cfg) * 4 * 8 / 1e6,
                      RuntimeModelConfig(beta_seconds=BETA),
                      fed.clients_per_round, heterogeneity=het)
    return AGGREGATION_REGISTRY.get(fed.aggregation)()(
        lambda p, b: model_loss(p, {"tokens": b["x"]}), params, data, fed,
        rt, **({} if backend is None else {"backend": backend}))


def stream_lm(torch, params):
    """(ii) qwen1.5-0.5b at full width (phase lm's params), int8 uplink,
    16 clients a round in slabs of 4 for ``STREAM_ROUNDS`` rounds; one
    checked slab round more; one round of U = 4 as one slab against the
    dense U = 4 round. Returns the launches."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data import make_lm_clients
    from repro_torch.launch.lm_train_timing import SEQ
    from repro_torch.optim import tree_leaves
    cfg = get_arch(LM_ARCH)
    sizes = [int(t.numel()) for t in tree_leaves(params)]
    data = make_lm_clients(np.random.default_rng(0),
                           LM_STREAM["total_clients"], vocab=cfg.vocab_size,
                           seq_len=SEQ)
    fed = _lm_fed(rounds=STREAM_ROUNDS, **LM_STREAM)
    n_slabs = -(-fed.clients_per_round // fed.cohort_chunk)

    def make():
        tr = _lm_engine(cfg, params, data, fed)
        tr._ms = timed_rounds(torch, tr.engine)
        return tr

    tr, h, counts, peak, peak_abs, run_s = _peak_run(
        torch, make, lambda t: t.run(STREAM_ROUNDS))
    want = STREAM_ROUNDS * n_slabs * len(sizes)
    only(counts, {"int8_decompress_reduce": want}, "stream (ii)")
    formula = lm_train_want(fed, sizes, STREAM_ROUNDS)
    got = {key: getattr(h, key) for key in formula}
    if got != formula or not all(math.isfinite(v) for v in h.train_loss):
        raise AssertionError(f"stream (ii): counters {got} != {formula} "
                             f"or loss {h.train_loss}")
    ms, ks, losses = list(tr._ms), list(h.k), list(h.train_loss)
    # one slab round more, neither counted nor timed: every call at the
    # 14 leaf sizes (4 rows a slab) against its plain version
    h2, seen = check_calls(torch, lambda: tr.run(1), "stream (ii)")
    got_calls = {k: v["calls"] for k, v in seen.items()}
    red = seen.get("int8_decompress_reduce", {})
    if got_calls != {"int8_decompress_reduce": n_slabs * len(sizes)} or \
            sorted(red["m"]) != sorted(sizes * n_slabs) or \
            set(red["n"]) != {fed.cohort_chunk}:
        raise AssertionError(f"stream (ii): checked round ran {seen}")
    del tr
    _free(torch)
    # U = 4: one slab of the whole cohort against the dense round
    pair = {}
    for chunk in (None, 4):
        f4 = _lm_fed(rounds=1, total_clients=LM_STREAM["total_clients"],
                     clients_per_round=4, cohort_chunk=chunk)
        t4 = _lm_engine(cfg, params, data, f4)
        h4 = t4.run(1)
        pair[chunk] = (h4.train_loss, [t.clone() for t in
                                       tree_leaves(t4.params)])
        del t4
        _free(torch)
    if pair[None][0] != pair[4][0] or not all(
            torch.equal(a, b) for a, b in zip(pair[None][1], pair[4][1])):
        raise AssertionError("stream (ii): one slab of U = 4 is not the "
                             "dense U = 4 round")
    del pair
    _free(torch)
    emit({"phase": "stream", "what": "(ii) qwen1.5-0.5b full width, int8 "
          "uplink, 16 clients a round in 4 slabs of 4",
          "arch": cfg.name, "params": sum(sizes), "leaves": len(sizes),
          "clients": fed.total_clients, "u": fed.clients_per_round,
          "c": fed.cohort_chunk, "k": ks, "loss": losses,
          "counters_exact": True, "ms_per_round": ms, "run_s": run_s,
          "peak_gb_over_base": peak,
          "peak_gb": peak_abs,
          "int8_decompress_reduce_launches": want,
          "checked_round": {k: {"calls": v["calls"], "leaves": len(sizes),
                                "rows": sorted(set(v["n"])),
                                "max_abs_err": v["max_abs_err"],
                                "tol": v["tol"]} for k, v in seen.items()},
          "u4_one_slab_bitwise_dense": True})
    return counts


def stream_population(torch):
    """(iii) ``population-chunked.json`` as written through
    ``launch.train`` (20 rounds, 32 a round in 8 slabs of 4, int8); the
    same spec at C = 32 for 2 rounds against its dense run. Returns the
    launches of the launcher's run."""
    from repro_torch.api import ExperimentSpec, build
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import round as round_mod
    from repro_torch.launch import train
    from repro_torch.optim import tree_leaves
    spec = ExperimentSpec.load(str(SPEC_DIR / "population-chunked.json"))
    ms, chunked = [], round_mod.RoundEngine.run_round_chunked

    def timed(self, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = chunked(self, *a)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        return out

    round_mod.RoundEngine.run_round_chunked = timed
    try:
        zero_counts()
        exp, out = _quiet(train.main, ["--spec", str(
            SPEC_DIR / "population-chunked.json")])
        counts = kernel_counts()
    finally:
        round_mod.RoundEngine.run_round_chunked = chunked
    f = spec.fed
    leaves = len(tree_leaves(exp.params))
    n_slabs = -(-f.clients_per_round // f.cohort_chunk)
    only(counts, {"int8_decompress_reduce": leaves * n_slabs * f.rounds},
         "stream (iii)")
    h = exp.history
    if h.rounds != list(range(1, f.rounds + 1)) or not all(
            math.isfinite(v) for v in h.train_loss):
        raise AssertionError(f"stream (iii): rounds {h.rounds}, loss "
                             f"{h.train_loss}")
    if f"{f.rounds} dispatch(es)" not in out:
        raise AssertionError(f"stream (iii): the launcher said:\n{out}")
    del exp
    _free(torch)
    pair = {}
    for chunk in (None, f.clients_per_round):
        d = spec.as_dict()
        d["fed"].update(rounds=2, cohort_chunk=chunk)
        e = build(ExperimentSpec.from_dict(d))
        e.run()
        pair[chunk] = (e.history.train_loss, _host(e.params),
                       _host(e.trainer.engine.transport_state))
        del e
    (ld, pd, sd), (lc, pc, sc) = pair[None], pair[f.clients_per_round]
    if ld != lc or not _bitwise(pd, pc) or not _bitwise(sd, sc):
        raise AssertionError(f"stream (iii): C = 32 is not the dense run: "
                             f"{_max_diff(pd, pc)}")
    emit({"phase": "stream", "what": "(iii) population-chunked.json, "
          "launch.train", "population": spec.sampler.population,
          "clients": spec.data.clients, "u": f.clients_per_round,
          "c": f.cohort_chunk, "rounds": f.rounds, "leaves": leaves,
          "k": h.k[:3] + ["..."] + h.k[-2:],
          "loss_first_last": [h.train_loss[0], h.train_loss[-1]],
          "ms_per_round": sum(ms) / len(ms), "ms_first_rounds": ms[:3],
          "int8_decompress_reduce_launches": counts[
              "int8_decompress_reduce"],
          "c32_bitwise_dense_2_rounds": True,
          "wall_clock_s": h.wall_clock_s[-1],
          "uplink_mbit": h.uplink_mbit[-1]})
    return counts


def stream_topk(torch):
    """(iv) reduced ``fixed-cohort-topk`` (cohort [0, 3, 5, 9]) dense and
    at C = 4 and C = 2 for 2 rounds each, every slab's
    ``topk_scatter_reduce`` call held exactly against its plain version.
    Returns the launches."""
    from repro_torch.api import ExperimentSpec, build
    spec = ExperimentSpec.load(str(SPEC_DIR / "fixed-cohort-topk.json"))
    total, runs, checked = {}, {}, {}
    for chunk in (None, 4, 2):
        d = spec.as_dict()
        d["fed"].update(rounds=2, cohort_chunk=chunk)
        e = build(ExperimentSpec.from_dict(d))
        zero_counts()
        h, seen = check_calls(torch, e.run, f"stream (iv) C={chunk}")
        counts = kernel_counts()
        leaves = len(_host(e.params))
        slabs = 1 if chunk is None else 4 // chunk
        only(counts, {"topk_scatter_reduce": 2 * slabs * leaves},
             f"stream (iv) C={chunk}")
        if set(seen) != {"topk_scatter_reduce"} or \
                set(seen["topk_scatter_reduce"]["n"]) != {chunk or 4}:
            raise AssertionError(f"stream (iv) C={chunk}: calls {seen}")
        slots = {t.shape[0] for t in
                 _host(e.trainer.engine.transport_state).values()}
        if slots != {4}:
            raise AssertionError(f"stream (iv) C={chunk}: slots {slots}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        runs[chunk] = (h.train_loss, _host(e.params),
                       _host(e.trainer.engine.transport_state))
        checked[chunk] = seen["topk_scatter_reduce"]
        del e
        _free(torch)
    (ld, pd, sd), (l4, p4, s4) = runs[None], runs[4]
    if ld != l4 or not _bitwise(pd, p4) or not _bitwise(sd, s4):
        raise AssertionError("stream (iv): C = 4 is not the dense run")
    emit({"phase": "stream", "what": "(iv) fixed-cohort-topk reduced, "
          "dense / C=4 / C=2", "loss": {str(c or "dense"): r[0]
                                        for c, r in runs.items()},
          "c4_bitwise_dense": True,
          "c2_max_abs_diff": _max_diff(runs[2][1], pd),
          "topk_scatter_reduce": {str(c or "dense"): {"calls": v["calls"],
                                           "rows": sorted(set(v["n"])),
                                           "max_abs_err": v["max_abs_err"],
                                           "tol": v["tol"]}
                                  for c, v in checked.items()}})
    return total


def phase_stream(torch, cifar, params):
    """Streaming cohorts (``fed.cohort_chunk``): (i) CIFAR100, (ii)
    qwen1.5-0.5b at full width, (iii) ``population-chunked.json``, (iv)
    reduced ``fixed-cohort-topk``. Returns each kernel's launches."""
    t0 = time.perf_counter()
    total = {}
    for counts in (stream_cifar(torch, cifar), stream_lm(torch, params),
                   stream_population(torch), stream_topk(torch)):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    emit({"phase": "stream", "summary": True, "launches": total,
          "s": time.perf_counter() - t0})
    return total


def _folds(tr) -> int:
    """The arrivals an async engine folded (each one launch a leaf)."""
    return tr.applied_updates + tr._buf_count


def async_spec(torch, tmp):
    """(i) ``async-buffered.json`` as written through ``launch.train``
    (12 applications); saved after 4 applications, restored through
    ``FederatedExperiment.restore`` and resumed to 12: bitwise the
    uninterrupted run. Returns the launcher run's launches."""
    from repro_torch.api import ExperimentSpec, FederatedExperiment, build
    from repro_torch.launch import train
    path = str(SPEC_DIR / "async-buffered.json")
    spec = ExperimentSpec.load(path)
    zero_counts()
    t0 = time.perf_counter()
    exp, out = _quiet(train.main, ["--spec", path])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = kernel_counts()
    tr = exp.trainer
    leaves = len(_host(tr.params))
    only(counts, {"int8_decompress_reduce": leaves * _folds(tr)},
         "async (i)")
    if "[train] aggregation=async: buffer_size=8" not in out or \
            f"[train] async: {tr.applied_updates} updates applied" not in out:
        raise AssertionError(f"async (i): the launcher said:\n{out}")
    straight = (exp.history.as_dict(), _host(tr.params),
                _host(tr.transport_state), dict(tr.staleness_hist))
    folds, dispatches = _folds(tr), tr.dispatch_count
    del exp, tr
    _free(torch)
    first = build(spec)
    first.trainer.run(ASYNC_SAVE_AT)
    ck = os.path.join(tmp, "async")
    first.save(ck)
    mid = (first.trainer._buf_count, len(first.trainer._heap))
    del first
    _free(torch)
    res = FederatedExperiment.restore(ck)
    res.trainer.run(spec.fed.rounds, resume=True)
    got = (res.history.as_dict(), _host(res.params),
           _host(res.trainer.transport_state),
           dict(res.trainer.staleness_hist))
    if got[0] != straight[0] or not _bitwise(got[1], straight[1]) or \
            not _bitwise(got[2], straight[2]) or got[3] != straight[3]:
        raise AssertionError(f"async (i): the resumed run is not the "
                             f"uninterrupted one: {_max_diff(got[1], straight[1])}")
    h = straight[0]
    emit({"phase": "async", "what": "(i) async-buffered.json, launch.train; "
          f"saved after {ASYNC_SAVE_AT}, restored, resumed",
          "applications": len(h["rounds"]), "folds": folds,
          "applied": h["applied_updates"][-1],
          "dropped": h["dropped_updates"][-1],
          "staleness_hist": straight[3], "dispatches": dispatches,
          "ms_per_application": run_s * 1e3 / len(h["rounds"]),
          "loss_first_last": [h["train_loss"][0], h["train_loss"][-1]],
          "wall_clock_s": h["wall_clock_s"][-1],
          "saved_mid_buffer": {"buf_count": mid[0], "heap": mid[1]},
          "resume_bitwise": True,
          "int8_decompress_reduce_launches": counts[
              "int8_decompress_reduce"]})
    return counts


def async_oracle(torch):
    """(ii) the sync-parity oracle (tests/test_async.py's base spec):
    heterogeneity 0, a buffer of the whole cohort, ``constant`` weight,
    K_r-rounds, against ``FedAvgTrainer`` on the same seed."""
    import numpy as np
    from repro_torch.api import ExperimentSpec, build
    base = ExperimentSpec().with_overrides(*ORACLE)
    hs = build(base).run()
    ha = build(base.with_overrides("fed.aggregation=async")).run()
    if ha.rounds != hs.rounds or ha.k != hs.k or ha.eta != hs.eta or \
            ha.wall_clock_s != hs.wall_clock_s or \
            ha.sgd_steps != hs.sgd_steps or \
            ha.downlink_mbit != hs.downlink_mbit or \
            any(s != 0.0 for s in ha.staleness):
        raise AssertionError("async (ii): the oracle's counters differ")
    np.testing.assert_allclose(ha.train_loss, hs.train_loss, rtol=0,
                               atol=5e-6)
    np.testing.assert_allclose(ha.uplink_mbit, hs.uplink_mbit, rtol=1e-12)
    emit({"phase": "async", "what": "(ii) sync-parity oracle", "k": ha.k,
          "loss_max_abs_diff": max(abs(a - b) for a, b in
                                   zip(ha.train_loss, hs.train_loss)),
          "tol": 5e-6})
    _free(torch)


def async_lm(torch, params):
    """(iii) qwen1.5-0.5b at full width, async: 12 clients, 4 in flight,
    a buffer of 2, ``inv``, max staleness 4, heterogeneity 0.8, int8
    uplink, ``LM_ASYNC_APPLIES`` applications; one application more holds
    every fold's call (N = 1) at the 14 leaf sizes against its plain
    version. Returns the launches."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.lm_train_timing import lm_data
    from repro_torch.optim import tree_leaves
    cfg = get_arch(LM_ARCH)
    sizes = [int(t.numel()) for t in tree_leaves(params)]
    fed = _lm_fed(rounds=LM_ASYNC_APPLIES, **LM_ASYNC)
    data = lm_data(cfg)
    tr, h, counts, peak, peak_abs, run_s = _peak_run(
        torch, lambda: _lm_engine(cfg, params, data, fed, LM_ASYNC_HET),
        lambda t: t.run(LM_ASYNC_APPLIES))
    folds = _folds(tr)
    only(counts, {"int8_decompress_reduce": folds * len(sizes)},
         "async (iii)")
    if not all(math.isfinite(v) for v in h.train_loss) or \
            tr.transport.ef_slots != fed.clients_per_round:
        raise AssertionError(f"async (iii): loss {h.train_loss}, slots "
                             f"{tr.transport.ef_slots}")
    hist, ks, losses = dict(tr.staleness_hist), list(h.k), list(h.train_loss)
    _, seen = check_calls(torch, lambda: tr.run(LM_ASYNC_APPLIES + 1),
                          "async (iii)")
    more = _folds(tr) - folds
    red = seen.get("int8_decompress_reduce", {})
    if {k: v["calls"] for k, v in seen.items()} != {
            "int8_decompress_reduce": more * len(sizes)} or \
            sorted(red["m"]) != sorted(sizes * more) or \
            set(red["n"]) != {1}:
        raise AssertionError(f"async (iii): checked application ran {seen}")
    emit({"phase": "async", "what": "(iii) qwen1.5-0.5b full width, async "
          "int8, 4 in flight, buffer 2", "arch": cfg.name,
          "params": sum(sizes), "leaves": len(sizes),
          "applications": LM_ASYNC_APPLIES, "folds": folds,
          "dispatch_groups": tr._dispatch_idx, "staleness_hist": hist,
          "k": ks, "loss": losses,
          "ms_per_application": run_s * 1e3 / LM_ASYNC_APPLIES,
          "peak_gb_over_base": peak,
          "peak_gb": peak_abs,
          "int8_decompress_reduce_launches": counts[
              "int8_decompress_reduce"],
          "checked_application": {"folds": more, "calls": red["calls"],
                                  "rows": sorted(set(red["n"])),
                                  "leaves": len(sizes),
                                  "max_abs_err": red["max_abs_err"],
                                  "tol": red["tol"]}})
    del tr
    _free(torch)
    return counts


def phase_async(torch, params):
    """Async buffered aggregation (``fed.aggregation="async"``): (i)
    ``async-buffered.json``, (ii) the sync-parity oracle, (iii)
    qwen1.5-0.5b at full width. Returns each kernel's launches."""
    import tempfile
    t0 = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, v in async_spec(torch, tmp).items():
            total[k] = total.get(k, 0) + v
    async_oracle(torch)
    for k, v in async_lm(torch, params).items():
        total[k] = total.get(k, 0) + v
    emit({"phase": "async", "summary": True, "launches": total,
          "s": time.perf_counter() - t0})
    return total


# ---------------------------------------------------------------------------
# serving while training (phase 15)
# ---------------------------------------------------------------------------

SERVE_SPEC = "serve-while-training.json"
# (ii): phase async (iii)'s configuration, a tick every 2 applications
SERVE_ASYNC_EVERY = 2
# the serving loop's traffic of serve-while-training.json
SERVE_TRAFFIC = dict(batch=2, prompt_len=4, tokens=8)


class DecodeLog:
    """Instrumentation of this script only: while active, every
    ``ServingLoop.decode`` call keeps its prompts, the token fed at each
    decode step and the argmax of the logits it returned (on the device,
    no synchronisation); the last call's record stays in ``last``."""

    def __init__(self):
        from repro_torch.core.serve import loop
        self.cls, self.decode, self.last = loop.ServingLoop, \
            loop.ServingLoop.decode, None

    def __enter__(self):
        decode = self.decode

        def logged(loop, prompt_ids, params=None):
            step, fed, top = loop._step, [], []

            def rec(p, cache, tok, pos):
                logits, cache = step(p, cache, tok, pos)
                fed.append(tok)
                top.append(logits.argmax(-1))
                return logits, cache
            loop._step = rec
            try:
                ids, dt = decode(loop, prompt_ids, params)
            finally:
                loop._step = step
            self.last = {"prompts": prompt_ids, "fed": fed, "argmax": top,
                         "ids": ids,
                         "params": loop.params if params is None else params}
            return ids, dt

        self.cls.decode = logged
        return self

    def __exit__(self, *exc):
        self.cls.decode = self.decode


def repeat_decode_on_cpu(torch, cfg, rec):
    """The decode ``rec`` (a ``DecodeLog`` record) repeated on the CPU from
    the same params, fed the card's tokens step by step: the card's argmax
    must equal the CPU's at every step where the CPU's top-2 gap exceeds
    2 x (atol + rtol x max |logit|) of ``PARITY_TOL``. Returns the steps
    compared, those that differ, the smallest gap and the largest logit."""
    from repro_torch.models import registry
    from repro_torch.optim import tree_map
    cpu = tree_map(lambda t: t.detach().cpu(), rec["params"])
    step = registry.decode_fn(cfg, moe_path="dense")
    fed = [t.cpu() for t in rec["fed"]]
    top = [t.cpu() for t in rec["argmax"]]
    n_prompt = len(fed) - rec["ids"].shape[1]
    cache = registry.init_cache(cpu, cfg, fed[0].shape[0], len(fed))
    compared = flips = 0
    min_gap, max_logit = math.inf, 0.0
    with torch.no_grad():
        for pos, tok in enumerate(fed):
            logits, cache = step(cpu, cache, tok, pos)
            if pos < n_prompt - 1:
                continue               # the prompt's own positions
            top2 = torch.topk(logits, 2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            max_logit = max(max_logit, float(logits.abs().max()))
            tol = 2 * (PARITY_TOL["atol"] + PARITY_TOL["rtol"] * max_logit)
            differ = top[pos] != torch.argmax(logits, dim=-1)
            if bool((differ & (gap > tol)).any()):
                raise AssertionError(
                    f"decode step {pos}: card {top[pos].tolist()} vs cpu "
                    f"{torch.argmax(logits, -1).tolist()}, gaps "
                    f"{gap.tolist()} over {tol}")
            compared += differ.numel()
            flips += int(differ.sum())
            min_gap = min(min_gap, float(gap.min()))
    if not torch.equal(torch.stack(top[n_prompt:], 1),
                       rec["ids"].cpu()):
        raise AssertionError("the logged argmax is not the decode's ids")
    return {"steps_compared": compared, "differ": flips,
            "min_top2_gap": min_gap, "max_abs_logit": max_logit}


def _served_tree_is_the_clients(trainer) -> bool:
    """The served params bitwise the tree clients hold: the downlink
    codec's load of the stored reference, else the params."""
    st, loop = trainer.store, trainer.serving
    dl = st.downlink
    want = (dl.load_tree(st.downlink_state["ref"], like=st.params)
            if dl is not None else st.params)
    return _bitwise(_host(loop.params), _host(want)) and _bitwise(
        _host(st.snapshot()[1]), _host(want))


def serve_sync(torch, tmp):
    """(i) ``serve-while-training.json`` at full width through
    ``launch.train``; its read-only rule (``fed.bucket_rounds=1`` with and
    without serving); one tick repeated on the CPU; one round more whose
    every wire call is held against its plain version. Returns the
    counted run's launches."""
    from repro_torch.api import ExperimentSpec, build
    from repro_torch.configs import get_arch
    from repro_torch.core.engine import round as round_mod
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves
    spec = ExperimentSpec.load(str(SPEC_DIR / SERVE_SPEC)).with_overrides(
        "model.reduced=false")
    sv, rounds = spec.serve, spec.fed.rounds
    rho = sv.qps * (sv.query_ms / 1e3)
    stretch = 1.0 / (1.0 - rho)
    cfg = get_arch(spec.model.arch + ("-reduced" if spec.model.reduced
                                      else ""))
    if registry.param_count(cfg) != LM_PARAMS:
        raise AssertionError(f"serve_train: {registry.param_count(cfg)} "
                             f"params, want {LM_PARAMS}")
    path = os.path.join(tmp, "serve.json")
    spec.save(path)
    # instrumentation of this script only: host clock around each bucket
    # (synchronised)
    buckets, run_bucket = [], round_mod.RoundEngine.run_bucket
    round_mod.RoundEngine.run_bucket = timed_buckets(torch, run_bucket,
                                                     buckets, method=True)
    try:
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with DecodeLog() as log:
            exp, out = _quiet(train.main, ["--spec", path])
        run_s = time.perf_counter() - t0
        counts = kernel_counts()
    finally:
        round_mod.RoundEngine.run_bucket = run_bucket
    tr, h = exp.trainer, exp.history
    fed = tr.fed
    sizes = [int(t.numel()) for t in tree_leaves(tr.params)]
    only(counts, {"int8_decompress_reduce": rounds * len(sizes),
                  "int8_decode_apply": rounds * len(sizes)},
         "serve_train (i)")
    line = [ln for ln in out.splitlines() if ln.startswith("[train] serve:")]
    every = sv.every
    ticks = [r for r in range(1, rounds + 1) if r % every == 0]
    # the staleness the reference defines: the versions the served model
    # fell behind by tick time, the rounds since the last swap
    if h.serve_rounds != ticks or h.serve_staleness != [every] * len(ticks) \
            or tr.serving.served_version != tr.store.version != rounds \
            or len(line) != 1:
        raise AssertionError(f"serve_train (i): ticks {h.serve_rounds}, "
                             f"staleness {h.serve_staleness}, served "
                             f"{tr.serving.served_version} of "
                             f"{tr.store.version}, line {line}")
    if not _served_tree_is_the_clients(tr):
        raise AssertionError("serve_train (i): the served tree is not the "
                             "q8 store's load of the reference")
    want = lm_train_want(fed, sizes, rounds, stretch, sv.qps)
    queries = want.pop("serve_queries")
    got = {k: getattr(h, k) for k in want}
    if got != want or tr.store.serve_queries != queries[-1]:
        raise AssertionError(f"serve_train (i): counters {got}, "
                             f"serve_queries {tr.store.serve_queries}; the "
                             f"formula's {want}, {queries[-1]}")
    if not all(math.isfinite(v) for v in h.train_loss):
        raise AssertionError(f"serve_train (i): losses {h.train_loss}")
    cpu_tick = repeat_decode_on_cpu(torch, cfg, log.last)
    served, hist = _host(tr.params), h.as_dict()
    queries = tr.store.serve_queries
    checked = check_lm_round(torch, tr, "serve_train (i)")
    calls = {k: v["calls"] for k, v in checked.items()}
    if calls != {"int8_decompress_reduce": len(sizes),
                 "int8_decode_apply": len(sizes)} or any(
            sorted(v["m"]) != sorted(sizes) for v in checked.values()):
        raise AssertionError(f"serve_train (i): checked round ran {checked}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "serve_train", "what": "(i) serve-while-training.json, "
          "full width, launch.train", "arch": cfg.name, "params": sum(sizes),
          "leaves": len(sizes), "rounds": rounds, "every": every,
          "qps": sv.qps, "query_ms": sv.query_ms, "rho": rho,
          "k": hist["k"], "loss": hist["train_loss"],
          "ms_per_round": per_round_ms(buckets),
          "ms_per_bucket": [ms for ms, _ in buckets], "s": run_s,
          "ticks": hist["serve_rounds"], "staleness": hist["serve_staleness"],
          "tokens_per_s": hist["serve_tokens_per_sec"],
          "swap_us": hist["serve_swap_us"],
          "wall_clock_s": hist["wall_clock_s"],
          "serve_queries": queries, "counters_exact": True,
          "served_version": tr.serving.served_version,
          "served_tree_bitwise_clients": True, "cpu_tick": cpu_tick,
          "launches": {k: v for k, v in counts.items() if v},
          "checked_round": {k: {"calls": v["calls"],
                                "max_abs_err": v["max_abs_err"],
                                "tol": v["tol"]}
                            for k, v in checked.items()},
          "peak_mem_gb": peak, "line": line[0]})
    del exp, tr, log
    _free(torch)
    # the read-only rule: serving changes nothing the trainer computes
    runs = {}
    for label, over in (("on", ()), ("off", ("serve.every=0",
                                             "serve.qps=0"))):
        e = build(spec.with_overrides("fed.bucket_rounds=1", *over))
        hh = e.run()
        runs[label] = (hh.as_dict(), _host(e.params))
        del e
        _free(torch)
    (hon, pon), (hoff, poff) = runs["on"], runs["off"]
    off_want = lm_train_want(fed, sizes, rounds)
    same = {k: hon[k] == hoff[k] for k in ("train_loss", "sgd_steps",
                                           "uplink_mbit", "downlink_mbit",
                                           "k")}
    walls_exact = (hon["wall_clock_s"] == want["wall_clock_s"]
                   and hoff["wall_clock_s"] == off_want["wall_clock_s"])
    if not (_bitwise(pon, poff) and all(same.values()) and walls_exact
            and _bitwise(pon, served)
            and hon["train_loss"] == hist["train_loss"]
            and hoff["serve_rounds"] == []):
        raise AssertionError(f"serve_train (i): read-only rule broken: "
                             f"params bitwise {_bitwise(pon, poff)}, "
                             f"{same}, walls exact {walls_exact}, as "
                             f"written {_bitwise(pon, served)}")
    emit({"phase": "serve_train", "what": "(i) read-only rule: "
          "fed.bucket_rounds=1, serve.every=2 qps 50 against serve.every=0 "
          "qps 0", "params_bitwise": True, "history_equal": same,
          "walls_off": hoff["wall_clock_s"], "walls_on": hon["wall_clock_s"],
          "walls_formula_exact": True, "stretch": stretch,
          "bitwise_the_bucket_rounds_4_run": True})
    return counts


def serve_async(torch, params):
    """(ii) phase async (iii)'s configuration (qwen1.5-0.5b at full width,
    4 in flight, a buffer of 2, int8) with a ``ServingLoop`` attached as
    ``build`` attaches it, a tick every 2 applications, for
    ``LM_ASYNC_APPLIES``; one application more holds every fold's call.
    Returns the launches."""
    from repro_torch.configs import get_arch
    from repro_torch.core.serve import ServingLoop
    from repro_torch.launch.lm_train_timing import lm_data
    from repro_torch.optim import tree_leaves
    cfg = get_arch(LM_ARCH)
    sizes = [int(t.numel()) for t in tree_leaves(params)]
    fed = _lm_fed(rounds=LM_ASYNC_APPLIES, **LM_ASYNC)
    data = lm_data(cfg)

    def make():
        tr = _lm_engine(cfg, params, data, fed, LM_ASYNC_HET)
        tr.serving = ServingLoop(tr.store, cfg, **SERVE_TRAFFIC)
        tr.serve_every = SERVE_ASYNC_EVERY
        return tr

    tr, h, counts, peak, peak_abs, run_s = _peak_run(
        torch, make, lambda t: t.run(LM_ASYNC_APPLIES))
    folds = _folds(tr)
    only(counts, {"int8_decompress_reduce": folds * len(sizes)},
         "serve_train (ii)")
    ticks = [r for r in range(1, LM_ASYNC_APPLIES + 1)
             if r % SERVE_ASYNC_EVERY == 0]
    if h.serve_rounds != ticks or \
            h.serve_staleness != [SERVE_ASYNC_EVERY] * len(ticks) or \
            tr.serving.served_version != tr.store.version or \
            not _served_tree_is_the_clients(tr):
        raise AssertionError(f"serve_train (ii): ticks {h.serve_rounds}, "
                             f"staleness {h.serve_staleness}, served "
                             f"{tr.serving.served_version} of "
                             f"{tr.store.version}")
    _, seen = check_calls(torch, lambda: tr.run(LM_ASYNC_APPLIES + 1),
                          "serve_train (ii)")
    more = _folds(tr) - folds
    red = seen.get("int8_decompress_reduce", {})
    if {k: v["calls"] for k, v in seen.items()} != {
            "int8_decompress_reduce": more * len(sizes)} or \
            sorted(red["m"]) != sorted(sizes * more) or \
            set(red["n"]) != {1}:
        raise AssertionError(f"serve_train (ii): checked application ran "
                             f"{seen}")
    emit({"phase": "serve_train", "what": "(ii) async (iii) with a tick "
          "every 2 applications", "arch": cfg.name,
          "applications": LM_ASYNC_APPLIES, "folds": folds,
          "ticks": h.serve_rounds, "staleness": h.serve_staleness,
          "tokens_per_s": h.serve_tokens_per_sec,
          "swap_us": h.serve_swap_us,
          "ms_per_application": run_s * 1e3 / LM_ASYNC_APPLIES,
          "peak_gb_over_base": peak, "peak_gb": peak_abs,
          "int8_decompress_reduce_launches": counts[
              "int8_decompress_reduce"],
          "checked_application": {"folds": more, "calls": red["calls"],
                                  "max_abs_err": red["max_abs_err"],
                                  "tol": red["tol"]}})
    del tr
    _free(torch)
    return counts


def phase_serve_train(torch, params):
    """Serving while training: (i) sync, (ii) async. Returns each kernel's
    launches over the two counted runs."""
    import tempfile
    t0 = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, v in serve_sync(torch, tmp).items():
            total[k] = total.get(k, 0) + v
    for k, v in serve_async(torch, params).items():
        total[k] = total.get(k, 0) + v
    emit({"phase": "serve_train", "summary": True,
          "launches": {k: v for k, v in total.items() if v},
          "s": time.perf_counter() - t0})
    return total


# ---------------------------------------------------------------------------
# the encoder-decoder and vision-language families (phase 16)
# ---------------------------------------------------------------------------

# the fleet runner (phase fleet): FEMNIST at paper width (DNN 200-200, U 60,
# b 32) over launch.fleet, packed on four streams and serial
FLEET_BASE = ("data.kind=paper", "data.task=femnist", "data.clients=300",
              "data.samples_per_client=170", "data.seed=0",
              "fed.clients_per_round=60", "fed.batch_size=32",
              "fed.eta0=0.3", "fed.k_schedule=rounds", "fed.k_quantize=true",
              "fed.aggregator=kernel", "fed.rounds=4",
              "runtime.beta_seconds=0.017")
FLEET_SWEEP = ("fed.k0=64,80", "transport.name=none,int8")
FEMNIST_PARAMS = 209_662
FLEET_CSV = (Path(__file__).resolve().parent / "build"
             / "fleet_leaderboard.csv")


def fleet_plan(points):
    """From the scheduler, without running anything: each point's buckets
    as (k, shape) pairs, and the distinct (program key, k, shape) pairs
    of all points (every point's bucket inputs have the same shapes but
    for K and the bucket's length)."""
    from repro_torch.api.experiment import _make_fed_config
    from repro_torch.api.sweep import spec_program_key
    from repro_torch.core.engine.scheduler import RoundScheduler
    from repro_torch.core.schedules import DecayController
    plans, keys = {}, set()
    for p in points:
        fed = _make_fed_config(p.spec)
        plan = [(b.k, b.shape_rounds, len(b)) for b in RoundScheduler(
            DecayController(fed), fed, total_rounds=fed.rounds).plan()]
        plans[p.label] = plan
        keys |= {(spec_program_key(p.spec), k, shape)
                 for k, shape, _ in plan}
    return plans, keys


def phase_fleet(torch):
    """The fleet runner on the card: ``FLEET_SWEEP`` over ``FLEET_BASE``
    with ``share_k_grid`` (four points, one K grid anchored at 80), packed
    (four ``LocalBackend`` slices, each on its own stream) and then serial,
    each with a fresh registry. Every point's params, losses and history
    bitwise equal between the two; the registry's builds equal the
    distinct (program key, bucket signature) pairs of the four plans (from
    the scheduler), each point's dispatches its buckets, and the shared
    counts add up; ``fedavg_reduce`` launches once a round of a plain
    point, ``int8_decompress_reduce`` once a leaf a round of an int8 point
    and ``int8_decode_apply`` never (no downlink codec), each count zeroed
    just before the run; the leaderboard CSV goes to ``build/``. Returns
    the packed run's launches."""
    from repro_torch.api import ExperimentSpec
    from repro_torch.api.sweep import expand_sweep
    from repro_torch.launch import fleet
    from repro_torch.optim import tree_leaves
    t0 = time.perf_counter()
    base = ExperimentSpec().with_overrides(*FLEET_BASE)
    points = fleet.share_k_grid(expand_sweep(*FLEET_SWEEP, base=base))
    plans, keys = fleet_plan(points)
    built, build = {}, fleet.build

    def recording(spec, **kw):
        exp = build(spec, **kw)
        built[(mode, spec.fed.k0, spec.transport.name)] = exp
        return exp

    results, launches = {}, {}
    fleet.build = recording
    try:
        for mode in ("packed", "serial"):
            _free(torch)
            zero_counts()
            results[mode] = fleet.run_fleet(points=points,
                                            packed=mode == "packed")
            torch.cuda.synchronize()
            launches[mode] = kernel_counts()
    finally:
        fleet.build = build
    rounds = base.fed.rounds
    n_int8 = sum(p.spec.transport.name == "int8" for p in points)
    leaves, n_params = None, None
    for (mode, k0, name), exp in built.items():
        if mode != "packed":
            continue
        other = built[("serial", k0, name)]
        a, b = tree_leaves(exp.params), tree_leaves(other.params)
        leaves, n_params = len(a), sum(t.numel() for t in a)
        if json.dumps(exp.history.as_dict()) != json.dumps(
                other.history.as_dict()) or not all(
                torch.equal(x.view(torch.int32), y.view(torch.int32))
                for x, y in zip(a, b)):
            raise AssertionError(f"fleet: point k0={k0} {name} packed is "
                                 f"not bitwise its serial run")
        if not all(math.isfinite(v) for v in exp.history.train_loss):
            raise AssertionError(f"fleet: k0={k0} {name} losses "
                                 f"{exp.history.train_loss}")
    if n_params != FEMNIST_PARAMS:
        raise AssertionError(f"fleet: {n_params} params, want "
                             f"{FEMNIST_PARAMS}")
    want = {k: 0 for k in launches["packed"]}
    want["fedavg_reduce"] = (len(points) - n_int8) * rounds
    want["int8_decompress_reduce"] = n_int8 * rounds * leaves
    for mode, res in results.items():
        if launches[mode] != want:
            raise AssertionError(f"fleet ({mode}): launches "
                                 f"{launches[mode]}, want {want}")
        per_point = {r.label: r for r in res.points}
        if res.compile_count != len(keys):
            raise AssertionError(f"fleet ({mode}): {res.compile_count} "
                                 f"programs built, the plans' distinct "
                                 f"pairs are {len(keys)}")
        touched = 0
        for label, plan in plans.items():
            r = per_point[label]
            if r.dispatch_count != len(plan) or r.rounds != rounds:
                raise AssertionError(f"fleet ({mode}): {label} dispatched "
                                     f"{r.dispatch_count} for a plan of "
                                     f"{len(plan)} buckets")
            touched += len({(k, shape) for k, shape, _ in plan})
        if res.compile_count + res.shared_count != touched or                 sum(r.compile_count for r in res.points)                 != res.compile_count:
            raise AssertionError(f"fleet ({mode}): {res.compile_count} "
                                 f"built + {res.shared_count} shared != "
                                 f"{touched} programs the points used")
    FLEET_CSV.parent.mkdir(parents=True, exist_ok=True)
    results["packed"].to_csv(str(FLEET_CSV))
    with open(FLEET_CSV) as f:
        header = f.readline().strip().split(",")
    if tuple(header) != fleet.CSV_FIELDS:
        raise AssertionError(f"fleet: csv header {header}")
    packed, serial = results["packed"], results["serial"]
    for r in packed.points:
        s = next(x for x in serial.points if x.label == r.label)
        emit({"phase": "fleet", "point": r.label, "k": built[
              ("packed", r.spec.fed.k0, r.spec.transport.name)].history.k,
              "buckets": plans[r.label], "final_loss": r.final_loss,
              "compiles": r.compile_count, "shared": r.shared_count,
              "dispatches": r.dispatch_count,
              "packed_rounds_per_s": r.rounds_per_sec,
              "serial_rounds_per_s": s.rounds_per_sec,
              "packed_wall_s": r.wall_s, "serial_wall_s": s.wall_s,
              "packed_peak_mb": r.peak_mb, "serial_peak_mb": s.peak_mb})
    summary = {"phase": "fleet", "summary": True, "points": len(points),
               "rounds": rounds, "params": n_params, "leaves": leaves,
               "packed_wall_s": packed.wall_s,
               "serial_wall_s": serial.wall_s,
               "compiles": packed.compile_count,
               "shared": packed.shared_count,
               "dispatches": packed.dispatch_count,
               "launches": launches["packed"], "bitwise_packed_serial": True,
               "csv": str(FLEET_CSV.relative_to(FLEET_CSV.parents[1])),
               "s": time.perf_counter() - t0}
    emit(summary)
    print(packed.leaderboard(), file=sys.stderr)
    return launches["packed"]


# ---------------------------------------------------------------------------
# the mesh's sequential strategy
# ---------------------------------------------------------------------------

SEQ_SPEC = "mesh-sequential-cosine.json"
SEQ_SPEC_ROUNDS = 3
# tests/test_torch_sequential.py's parity tolerance for this spec's run
# against LocalBackend (a 1x1 mesh is the local round)
SEQ_SPEC_TOL = dict(rtol=1e-4, atol=1e-4)
# (ii): stream (ii)'s traffic, 32 clients and 16 a round, in one group
LM_SEQUENTIAL = dict(total_clients=32, clients_per_round=16)
SEQ_ROUNDS = 2
# (iii): CIFAR100 at paper width, one round each against LocalBackend
SEQ_CIFAR = [("mean", dict(), 1), ("mean", dict(), 5),
             ("trimmed_mean+fedavgm", dict(aggregator="trimmed_mean",
                                           server_optimizer="fedavgm",
                                           server_lr=0.5), 5)]


def seq_spec(torch, smi):
    """(i) ``mesh-sequential-cosine.json`` at full width (``model.reduced
    =false``: qwen1.5-0.5b, weighted sampler, cosine K from k0 8, 4 a
    round) through ``launch.train`` for ``SEQ_SPEC_ROUNDS`` rounds, beside
    the same spec on ``backend.name=local``: K_r, ids, sgd_steps and wall
    clocks exact, params within ``SEQ_SPEC_TOL``; ms a round (each bucket
    between synchronisations, over its rounds) and the peak over base."""
    import numpy as np
    from repro_torch.core.engine.round import RoundEngine
    from repro_torch.launch import train
    argv = ["--spec", str(SPEC_DIR / SEQ_SPEC), "--set",
            "model.reduced=false", "--rounds", str(SEQ_SPEC_ROUNDS)]
    runs = {}
    for name in ("mesh", "local"):
        ids, undo = _recorded_ids()
        log, bucket = [], RoundEngine.run_bucket
        RoundEngine.run_bucket = timed_buckets(torch, bucket, log,
                                               method=True)
        _free(torch)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            exp, _ = _quiet(train.main, argv + (
                [] if name == "mesh" else ["--set", "backend.name=local"]))
        finally:
            RoundEngine.run_bucket = bucket
            undo()
        be = exp.trainer.engine.backend
        if (be.name, getattr(be, "strategy", "")) != (
                name, "sequential" if name == "mesh" else ""):
            raise AssertionError(f"sequential (i): ran on {be.name}")
        runs[name] = dict(h=exp.history, ids=list(ids),
                          params=_host(exp.trainer.params),
                          ms=per_round_ms(log), s=time.perf_counter() - t0,
                          peak=(torch.cuda.max_memory_allocated() - base)
                          / 1e9, counts=(exp.trainer.compile_count,
                                         exp.trainer.dispatch_count))
        del exp
        _free(torch)
    m, loc = runs["mesh"], runs["local"]
    for key in SPEC_COUNTERS:
        if getattr(m["h"], key) != getattr(loc["h"], key):
            raise AssertionError(f"sequential (i): {key} "
                                 f"{getattr(m['h'], key)} != "
                                 f"{getattr(loc['h'], key)}")
    if m["ids"] != loc["ids"] or len(m["ids"]) != SEQ_SPEC_ROUNDS or \
            m["counts"] != loc["counts"]:
        raise AssertionError(f"sequential (i): ids {m['ids']} vs "
                             f"{loc['ids']}, counts {m['counts']} vs "
                             f"{loc['counts']}")
    worst = 0.0
    for k, want in loc["params"].items():
        bound = SEQ_SPEC_TOL["atol"] + SEQ_SPEC_TOL["rtol"] * np.abs(want)
        worst = max(worst, float(np.max(np.abs(m["params"][k] - want)
                                        / bound)))
    if not worst <= 1.0 or not all(math.isfinite(v)
                                   for v in m["h"].train_loss):
        raise AssertionError(f"sequential (i): params at {worst} of "
                             f"{SEQ_SPEC_TOL}, loss {m['h'].train_loss}")
    emit({"phase": "sequential", "what": "(i) mesh-sequential-cosine.json, "
          "qwen1.5-0.5b full width, 1-rank NCCL mesh vs backend local",
          "card": smi, "rounds": SEQ_SPEC_ROUNDS, "k": m["h"].k,
          "ids": m["ids"], "counters_exact": True,
          "compiles_dispatches": m["counts"],
          "loss": m["h"].train_loss, "local_loss": loc["h"].train_loss,
          "max_abs_diff": _max_diff(m["params"], loc["params"]),
          "share_of_tol": worst, "tol": SEQ_SPEC_TOL,
          "ms_per_round": m["ms"], "local_ms_per_round": loc["ms"],
          "peak_gb_over_base": m["peak"], "local_peak_gb_over_base":
          loc["peak"], "s": m["s"], "local_s": loc["s"]})


def seq_lm(torch, params, mesh, smi):
    """(ii) qwen1.5-0.5b at full width (phase lm's params), 32 clients and
    16 a round in one group, b 4, seq 32, K_r-rounds from k0 8, the int8
    uplink with aggregate error feedback and the int8 downlink, for
    ``SEQ_ROUNDS`` rounds at ``acc_dtype`` f32: ``int8_decode_apply``
    exactly once a leaf a round (the broadcast, once a round) and no
    other kernel, counters exact against the runtime formula; one round
    more holds every decode-apply call against its plain version. Then
    one round at ``acc_dtype`` bf16 on the plain uplink (the codec's
    decoded sum is f32 whatever ``acc_dtype``, as the reference's), the
    int8 downlink kept. ms a round, ms a client and the allocator's peak
    over base of each. Returns the counted run's launches."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.engine.backends import MeshBackend
    from repro_torch.data import make_lm_clients
    from repro_torch.launch.lm_train_timing import SEQ
    from repro_torch.optim import tree_leaves
    cfg = get_arch(LM_ARCH)
    sizes = [int(t.numel()) for t in tree_leaves(params)]
    data = make_lm_clients(np.random.default_rng(0),
                           LM_SEQUENTIAL["total_clients"],
                           vocab=cfg.vocab_size, seq_len=SEQ)
    out = {}
    for acc, rounds, kw in ((torch.float32, SEQ_ROUNDS, {}),
                            (torch.bfloat16, 1, dict(transport="none"))):
        fed = _lm_fed(rounds=rounds, downlink="int8", **LM_SEQUENTIAL,
                      **kw)

        def make():
            tr = _lm_engine(cfg, params, data, fed, backend=MeshBackend(
                mesh, strategy="sequential", groups=1, acc_dtype=acc))
            tr._ms = timed_rounds(torch, tr.engine)
            return tr

        tr, h, counts, peak, peak_abs, run_s = _peak_run(
            torch, make, lambda t: t.run(rounds))
        name = str(acc).replace("torch.", "")
        only(counts, {"int8_decode_apply": rounds * len(sizes)},
             f"sequential (ii) {name}")
        formula = lm_train_want(fed, sizes, rounds)
        got = {key: getattr(h, key) for key in formula}
        if got != formula or not all(math.isfinite(v)
                                     for v in h.train_loss):
            raise AssertionError(f"sequential (ii) {name}: counters {got} "
                                 f"!= {formula} or loss {h.train_loss}")
        ks, losses = list(h.k), list(h.train_loss)
        line = {"phase": "sequential", "what": f"(ii) qwen1.5-0.5b full "
                f"width, 16 clients a round one at a time, acc_dtype "
                f"{name}", "card": smi, "arch": cfg.name,
                "params": sum(sizes), "leaves": len(sizes),
                "clients": fed.total_clients, "u": fed.clients_per_round,
                "groups": 1, "uplink": fed.transport,
                "downlink": fed.downlink, "acc_dtype": name, "k": ks,
                "loss": losses, "counters_exact": True,
                "ms_per_round": list(tr._ms),
                "ms_per_client": [ms / fed.clients_per_round
                                  for ms in tr._ms],
                "run_s": run_s, "peak_gb_over_base": peak,
                "peak_gb": peak_abs, "launches": counts}
        if acc == torch.float32:
            # one round more, neither counted nor timed
            h2, seen = check_calls(torch, lambda: tr.run(1),
                                   "sequential (ii)")
            app = seen.get("int8_decode_apply", {})
            if set(seen) != {"int8_decode_apply"} or \
                    app["calls"] != len(sizes) or \
                    sorted(app["m"]) != sorted(sizes):
                raise AssertionError(f"sequential (ii): checked round ran "
                                     f"{seen}")
            line["checked_round"] = {k: {
                "calls": v["calls"], "leaves": len(sizes),
                "max_abs_err": v["max_abs_err"], "tol": v["tol"]}
                for k, v in seen.items()}
            out = counts
        emit(line)
        del tr
        _free(torch)
    return out


def seq_cifar(torch, data, mesh, smi):
    """(iii) CIFAR100 at paper width (U 25, b 32, K 50, cuDNN
    deterministic), one round each of ``SEQ_CIFAR``, the sequential
    strategy against ``LocalBackend``: bitwise where it holds, else the
    measured distance, held to stream (i)'s bound (``c3_shares``: the f32
    tolerance plus a share of each leaf's movement; the per-client convs
    and matmuls take other cuDNN and cuBLAS algorithms than the vmapped
    cohort's)."""
    from repro_torch.configs import get_paper_task
    from repro_torch.core import FedAvgTrainer, RuntimeModel
    from repro_torch.core.engine.backends import MeshBackend
    from repro_torch.models import small
    task = get_paper_task("cifar100")
    init = _host(small.init_task_model(0, task))
    for label, kw, groups in SEQ_CIFAR:
        fed = dataclasses.replace(task.fed, rounds=1, k_schedule="rounds",
                                  **kw)
        runs = {}
        for name in ("sequential", "local"):
            backend = (MeshBackend(mesh, strategy="sequential",
                                   groups=groups)
                       if name == "sequential" else None)
            tr = FedAvgTrainer(lambda p, b: small.task_loss(p, task, b),
                               small.init_task_model(0, task), data, fed,
                               RuntimeModel(task.model_size_mb, task.runtime,
                                            fed.clients_per_round),
                               backend=backend)
            tr._ms = timed_rounds(torch, tr.engine)
            h = tr.run(1)
            runs[name] = (h, _host(tr.params), list(tr._ms))
            del tr
            _free(torch)
        (hs, ps, ms), (hl, pl, ml) = runs["sequential"], runs["local"]
        if hs.k != hl.k or hs.sgd_steps != hl.sgd_steps or \
                not all(math.isfinite(v) for v in hs.train_loss):
            raise AssertionError(f"sequential (iii) {label}: {hs.k} "
                                 f"{hs.train_loss} vs {hl.k}")
        worst, worst_mean = c3_shares(pl, ps, init)
        if worst > 1.0 or worst_mean > 1.0:
            raise AssertionError(f"sequential (iii) {label} groups "
                                 f"{groups}: {worst}, {worst_mean} of the "
                                 f"bound")
        emit({"phase": "sequential", "what": f"(iii) cifar100 paper width, "
              f"{label}, groups {groups}, vs LocalBackend", "card": smi,
              "k": hs.k, "loss": hs.train_loss, "local_loss": hl.train_loss,
              "bitwise": _bitwise(ps, pl), "max_abs_diff": _max_diff(ps, pl),
              "share_of_bound": worst, "mean_share_of_bound": worst_mean,
              "ms_per_round": ms, "local_ms_per_round": ml,
              "cudnn_deterministic": True})


def phase_sequential(torch, cifar, params, smi):
    """The mesh's sequential strategy on a one-rank NCCL mesh: (i) the
    spec at full width through the launcher, (ii) qwen1.5-0.5b at 16
    clients a round, (iii) CIFAR100 against LocalBackend. Returns (ii)'s
    counted launches."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    det = torch.backends.cudnn.deterministic
    mesh = init_world1(torch)["data"][0]
    try:
        seq_spec(torch, smi)
        launches = seq_lm(torch, params, mesh, smi)
        torch.backends.cudnn.deterministic = True
        seq_cifar(torch, cifar, mesh, smi)
    finally:
        torch.backends.cudnn.deterministic = det
        del mesh
        dist.destroy_process_group()
    emit({"phase": "sequential", "summary": True, "card": smi,
          "launches": launches, "s": time.perf_counter() - t0})
    return launches


WHISPER_ARCH = "whisper-tiny"
WHISPER_PARAMS = 36_448_128
# Whisper's text context (arXiv:2212.04356) over its 1,500 audio frames
WHISPER_BATCH, WHISPER_SEQ = 2, 448
LLAVA_ARCH = "llava-next-34b"
LLAVA_FULL_PARAMS = 34_388_917_248
# 12 of its 60 layers: all 60 hold 137.6 GB in f32, past the card's 80 GB
LLAVA_LAYERS = 12
LLAVA_PARAMS = 7_611_792_384


def all_launches():
    """Every kernel's launch count, by name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ssd_scan as ss
    return {**kernel_counts(), "flash_attention": fa.launches,
            "gmm": mg.launches, "ssd_scan": ss.launches}


def phase_whisper(torch):
    """(i) whisper-tiny at full width and depth (36,448,128 f32 params from
    seed 0): the prefill step (B 2, 1,500 audio frames, decoder S 448) on
    the card against the CPU, then the launcher's direct audio decode
    (``launch.serve.decode_audio``, batch 4, prompt 16, 32 tokens):
    tokens/s and peak, the card's ids against the CPU's up to the first
    step where the CPU's top-2 gap allows another choice. No kernel runs,
    as in the reference. Returns the launches (all zero)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import make_prefill_step
    from repro_torch.kernels import flash_attention, moe_gmm, ssd_scan
    from repro_torch.launch.serve import decode_audio
    from repro_torch.models import registry
    from repro_torch.optim import tree_leaves, tree_map
    cfg = get_arch(WHISPER_ARCH)
    cpu = registry.init(0, cfg, device="cpu")
    n = sum(t.numel() for t in tree_leaves(cpu))
    if n != WHISPER_PARAMS or registry.param_count(cfg) != WHISPER_PARAMS:
        raise AssertionError(f"whisper: {n} params, want {WHISPER_PARAMS}")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for mod in (flash_attention, moe_gmm, ssd_scan):
        reset_counts(mod)
    card = tree_map(lambda t: t.to("cuda"), cpu)
    toks = torch.tensor(_lm_tokens(cfg, WHISPER_BATCH, WHISPER_SEQ, 12))
    extra = frontend_inputs(torch, cfg, WHISPER_BATCH, 12)
    step = make_prefill_step(cfg, use_kernel=True)
    batch = {"tokens": toks.cuda(), **{k: v.cuda() for k, v in extra.items()}}
    times = []
    for _ in range(4):
        got, ms = run_step(torch, step, card, batch)
        times.append(ms)
    with torch.no_grad():
        want = make_prefill_step(cfg)(cpu, {"tokens": toks, **extra})
    if got.shape != (WHISPER_BATCH, cfg.vocab_size):
        raise AssertionError(f"whisper prefill {tuple(got.shape)}")
    torch.testing.assert_close(got.cpu(), want, **PARITY_TOL)
    dec = {}
    for dev, p in (("cuda", card), ("cpu", cpu)):
        dec[dev] = decode_audio(p, cfg, **SERVE, seed=0)
    ids, dt, _ = dec["cuda"]
    ids_cpu, _, logits_cpu = dec["cpu"]
    agree, min_gap = [], math.inf
    tol_of = lambda lg: 2 * (PARITY_TOL["atol"] + PARITY_TOL["rtol"]
                             * float(lg.abs().max()))
    for b in range(SERVE["batch"]):
        differ = (ids[b].cpu() != ids_cpu[b]).nonzero()
        t = int(differ[0]) if len(differ) else SERVE["tokens"]
        agree.append(t)
        if t < SERVE["tokens"]:
            top2 = torch.topk(logits_cpu[b, t], 2).values
            gap = float(top2[0] - top2[1])
            min_gap = min(min_gap, gap)
            if gap > tol_of(logits_cpu[b, t]):
                raise AssertionError(f"whisper decode row {b} step {t}: "
                                     f"card {ids[b].tolist()} vs cpu "
                                     f"{ids_cpu[b].tolist()}, gap {gap}")
    launches = all_launches()
    if any(launches.values()):
        raise AssertionError(f"whisper launched a kernel: {launches}")
    order = sorted(times[1:])
    emit({"phase": "encdec", "what": "(i) whisper-tiny full width: "
          "prefill card vs cpu, launcher audio decode", "arch": cfg.name,
          "params": n, "encoder_layers": cfg.encoder_layers,
          "decoder_layers": cfg.num_layers, "audio_frames": cfg.encoder_seq,
          "prefill_batch": WHISPER_BATCH, "prefill_seq": WHISPER_SEQ,
          "prefill_ms": order[len(order) // 2], "prefill_ms_runs": times,
          "logits_max_abs_err_vs_cpu": float((got.cpu() - want).abs().max()),
          "tol": PARITY_TOL, **SERVE,
          "tokens_per_s": SERVE["batch"] * SERVE["tokens"] / dt,
          "ids_agree_steps_by_row": agree, "min_top2_gap_at_split": (
              None if min_gap == math.inf else min_gap),
          "ids": ids.tolist()[:2], "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del card, cpu
    _free(torch)
    return launches


def phase_encdec(torch):
    """(i) whisper-tiny, (ii) llava-next-34b at full width and 12 of 60
    layers: the f32 prefill through flash (``phase_lm``: 12 launches a
    prefill on ``"wgmma_split"``, the plain path on the same batch,
    ``ServingLoop`` decode at batch 4), then the same in bf16 (12 launches
    on ``"wgmma"``, ``BF16_ANCHOR_FACTOR``). Returns {kernel: launches}
    over the f32 and bf16 prefills."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import registry
    t0 = time.perf_counter()
    phase_whisper(torch)
    full = get_arch(LLAVA_ARCH)
    if registry.param_count(full) != LLAVA_FULL_PARAMS:
        raise AssertionError(f"llava: {registry.param_count(full)} params")
    cfg = dataclasses.replace(full, num_layers=LLAVA_LAYERS)
    llava_fields = lambda c: {
        "layers": c.num_layers, "of_layers": full.num_layers,
        "full_params": LLAVA_FULL_PARAMS, "d_model": c.d_model,
        "heads": c.num_heads, "kv_heads": c.num_kv_heads,
        "head_dim": c.head_dim, "d_ff": c.d_ff,
        "patch_tokens": c.num_patch_tokens,
        "text_tokens": LM_SEQ - c.num_patch_tokens}
    # every llava check compares kernel and plain on the card's weights,
    # so they are drawn there
    launches, params = phase_lm(torch, "encdec", LLAVA_ARCH, LLAVA_PARAMS,
                                (FLASH,), 13, PARITY_TOL, llava_fields,
                                cfg=cfg, gen=torch.Generator(device="cuda"))
    bf16 = phase_bf16_prefill(torch, "encdec", cfg, params,
                              {"flash": (fa, "flash_attention",
                                         LLAVA_LAYERS)}, 13)
    del params
    _free(torch)
    total = {"flash_attention": launches["flash_attention"] + bf16["flash"]}
    emit({"phase": "encdec", "summary": True, "launches": total,
          "flash_f32": launches["flash_attention"],
          "flash_bf16": bf16["flash"], "s": time.perf_counter() - t0})
    return total


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

    name, smi = phase_device(torch)
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
    phase_parity_lm(torch, ENCDEC_PARITY)
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
    _free(torch)
    spec_launches = phase_spec(torch)
    if not all(spec_launches[k] for k in ("int8_decompress_reduce",
                                          "topk_scatter_reduce",
                                          "fedavg_reduce")):
        raise AssertionError(f"a kernel of phase spec never ran: "
                             f"{spec_launches}")
    # streaming cohorts and async buffering, on phase lm's params
    stream_launches = phase_stream(torch, cifar, params)
    async_launches = phase_async(torch, params)
    if not all(stream_launches[k] for k in ("int8_decompress_reduce",
                                            "topk_scatter_reduce",
                                            "fedavg_reduce")) or \
            not async_launches["int8_decompress_reduce"]:
        raise AssertionError(f"a kernel of phase stream or async never "
                             f"ran: {stream_launches}, {async_launches}")
    # serving while training, sync at full width and async on phase lm's
    # params
    serve_launches = phase_serve_train(torch, params)
    if not all(serve_launches[k] for k in ("int8_decompress_reduce",
                                           "int8_decode_apply")):
        raise AssertionError(f"a kernel of phase serve_train never ran: "
                             f"{serve_launches}")
    # the fleet runner: sweep points packed on streams, then serial
    fleet_launches = phase_fleet(torch)
    if not all(fleet_launches[k] for k in ("fedavg_reduce",
                                           "int8_decompress_reduce")):
        raise AssertionError(f"a kernel of phase fleet never ran: "
                             f"{fleet_launches}")
    # the mesh's sequential strategy, on phase lm's params
    sequential_launches = phase_sequential(torch, cifar, params, smi)
    if not sequential_launches["int8_decode_apply"]:
        raise AssertionError(f"int8_decode_apply never ran in phase "
                             f"sequential: {sequential_launches}")
    del params
    _free(torch)
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
    # zamba2's checks stay on the card too: its weights are drawn there
    phase_lm(torch, "zamba2", ZAMBA_ARCH, ZAMBA_PARAMS, (FLASH, SSD), 11,
             SSM_STATE_TOL, ssm_fields, gen=torch.Generator(device="cuda"))
    encdec_launches = phase_encdec(torch)
    if not encdec_launches["flash_attention"]:
        raise AssertionError("flash never ran in phase encdec")

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
    # the LM path: launches in phases lm_train and spec, and each row at
    # qwen's embedding leaf
    for entry in kernels:
        if entry["name"] in train_launches:
            entry["lm_train_launches"] = train_launches[entry["name"]]
        entry["spec_launches"] = spec_launches.get(entry["name"], 0)
        entry["stream_launches"] = stream_launches.get(entry["name"], 0)
        entry["async_launches"] = async_launches.get(entry["name"], 0)
        entry["serve_train_launches"] = serve_launches.get(entry["name"], 0)
        entry["encdec_launches"] = encdec_launches.get(entry["name"], 0)
        entry["fleet_launches"] = fleet_launches.get(entry["name"], 0)
        entry["sequential_launches"] = sequential_launches.get(
            entry["name"], 0)
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
