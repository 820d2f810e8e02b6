"""Device time of the SSD scan's passes, the int8 decompress-reduce, and
the f32 grouped matmul and flash attention beside their library calls.

Compares two checkouts of the port on one card: run it once for each, in
turns, with ``PYTHONPATH`` naming the checkout's ``src`` (the script calls
only ``ssd_scan(x, dt, A, b, c, D, chunk=...)``,
``int8_decompress_reduce(q, w[, qr, wr])``, ``gmm(x, w)`` and
``flash_attention(q, k, v, causal=...)``, which every version of the port
has)::

    PYTHONPATH=<checkout>/src python3 \
        src/repro_torch/launch/kernel_timing.py --label <name> \
        [--only scan int8 gmm flash]

It prints the card (``nvidia-smi``'s name and power limit), then one JSON
line for each of:

- the scan at each shape of ``SCAN_SHAPES`` (the mamba2-780m prefill's in
  f32 and bf16, zamba2-7b's in f32; ``chip_smoke.py``'s ``ssd_inputs``):
  the mean device µs a call of every kernel ``torch.profiler`` saw in
  ``--reps`` calls after a warm-up, and their sum;
- the int8 decompress-reduce at every CIFAR100 (N 25) and FEMNIST (N 60)
  leaf, one and two planes: the median device ms of ``--reps`` calls from
  CUDA events, L2 flushed by a 256 MB write before each
  (``chip_smoke.py``'s ``time_ms``), and the sums over each task's leaves;
- ``gmm`` in f32 at each shape of ``GMM_SHAPES`` (the phi3.5-moe prefill's
  gate/up and down, the decode floor C = 8; unit x, w of stddev d^-0.5)
  and flash attention in f32 at each shape of ``FLASH_SHAPES`` (the
  qwen1.5-0.5b prefill's, zamba2-7b's hd 112, nemotron-4-340b's hd 192,
  one query against 257 keys; q and k of stddev 1.6): the median device
  ms as for the int8 rows, beside ``torch.bmm`` or
  ``scaled_dot_product_attention`` on the same inputs (TF32 off), and the
  mean device µs of every kernel ``torch.profiler`` saw in a call.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

# (label, B, S, H, P, N, chunk, dtype)
SCAN_SHAPES = [
    ("prefill", 2, 4096, 48, 64, 128, 256, "float32"),
    ("prefill", 2, 4096, 48, 64, 128, 256, "bfloat16"),
    ("zamba2", 1, 4096, 112, 64, 64, 256, "float32"),
]
WIRE_TASKS = ("cifar100", "femnist")
# (label, E, C, d, f)
GMM_SHAPES = [("gate_up", 16, 1280, 4096, 6400),
              ("down", 16, 1280, 6400, 4096),
              ("decode_c8", 16, 8, 4096, 6400)]
# (label, B, H, KV, Sq, Sk, hd), causal
FLASH_SHAPES = [("prefill", 2, 16, 16, 4096, 4096, 64),
                ("zamba2.hd112", 2, 32, 32, 4096, 4096, 112),
                ("nemotron.hd192", 1, 96, 8, 2048, 2048, 192),
                ("sq1", 2, 16, 16, 1, 257, 64)]
PARTS = ("scan", "int8", "gmm", "flash")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def scan_inputs(B, S, H, P, N, dtype, seed=5):
    """Unit x, softplus(unit) dt, A = -exp(0.3 unit), b/c at 0.5."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    b = (torch.randn((B, S, N), generator=g, device="cuda") * 0.5).to(dtype)
    c = (torch.randn((B, S, N), generator=g, device="cuda") * 0.5).to(dtype)
    D = torch.linspace(0.5, 1.5, H, device="cuda")
    return x, dt, A, b, c, D


def kernel_name(key: str) -> str:
    """``chunk_state_wgmma<2>`` of the profiler's
    ``void (anonymous namespace)::chunk_state_wgmma<2>((anonymous ...``."""
    m = re.search(r"::(\w+(?:<[^()]*>)?)\(", key)
    return m.group(1) if m else key[:60]


def device_ms(fn, flush, reps: int) -> float:
    """Median device time of one call (CUDA events), L2 flushed by a write
    before each."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        events.append(ev)
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def leaf_items(tree, prefix: str):
    """(path, tensor) of a nested dict of tensors, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in leaf_items(v, f"{prefix}.{k}")]
    return [(prefix, tree)]


def leaves():
    """(task, leaf path, N, M) of every wire leaf, N the task's clients per
    round."""
    from repro_torch.configs import get_paper_task
    from repro_torch.models import small
    out = []
    for name in WIRE_TASKS:
        task = get_paper_task(name)
        params = small.init_task_model(0, task, device="cpu")
        out += [(name, path, task.fed.clients_per_round, leaf.numel())
                for path, leaf in leaf_items(params, name)]
    return out


def profile_us(fn, reps: int):
    """Mean device µs a call of each kernel ``torch.profiler`` saw in
    ``reps`` calls of ``fn`` after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {kernel_name(e.key): e.device_time_total / reps
            for e in prof.key_averages() if e.device_time_total > 0}


def time_gmm(label: str, card: str, flush, reps: int) -> None:
    from repro_torch.kernels import moe_gmm as mg
    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape, E, C, d, f in GMM_SHAPES:
        x = torch.randn((E, C, d), generator=gen, device="cuda")
        w = torch.randn((E, d, f), generator=gen, device="cuda") / d ** 0.5
        emit({"label": label, "kernel": "gmm", "shape": shape,
              "e": E, "c": C, "d": d, "f": f, "dtype": "float32",
              "card": card, "ms": device_ms(lambda: mg.gmm(x, w), flush,
                                            reps),
              "bmm_ms": device_ms(lambda: torch.bmm(x, w), flush, reps),
              "us_by_kernel": profile_us(lambda: mg.gmm(x, w), reps)})
        del x, w


def time_flash(label: str, card: str, flush, reps: int) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape, B, H, KV, sq, sk, hd in FLASH_SHAPES:
        q = torch.randn((B, H, sq, hd), generator=gen, device="cuda") * 1.6
        k = torch.randn((B, KV, sk, hd), generator=gen, device="cuda") * 1.6
        v = torch.randn((B, KV, sk, hd), generator=gen, device="cuda")
        call = lambda: fa.flash_attention(q, k, v, causal=True)
        # SDPA's causal mask is the top-left one: right for Sq == Sk only
        sdpa = (device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=H != KV), flush, reps)
            if sq == sk else None)
        emit({"label": label, "kernel": "flash_attention", "shape": shape,
              "b": B, "h": H, "kv": KV, "sq": sq, "sk": sk, "hd": hd,
              "dtype": "float32", "card": card,
              "ms": device_ms(call, flush, reps), "sdpa_ms": sdpa,
              "us_by_kernel": profile_us(call, reps)})
        del q, k, v


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import delta_codec as dc
    from repro_torch.kernels import ssd_scan as ss
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    flush = torch.empty(256 * 2 ** 20 // 4, device="cuda")
    if "gmm" in args.only:
        time_gmm(args.label, card, flush, args.reps)
    if "flash" in args.only:
        time_flash(args.label, card, flush, args.reps)
    for label, B, S, H, P, N, Q, dt_name in (
            SCAN_SHAPES if "scan" in args.only else []):
        xs = scan_inputs(B, S, H, P, N, getattr(torch, dt_name))
        for _ in range(3):
            ss.ssd_scan(*xs, chunk=Q)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                ss.ssd_scan(*xs, chunk=Q)
            torch.cuda.synchronize()
        passes = {kernel_name(e.key): e.device_time_total / args.reps
                  for e in prof.key_averages() if e.device_time_total > 0}
        emit({"label": args.label, "kernel": "ssd_scan", "shape": label,
              "dtype": dt_name, "card": card, "us_by_kernel": passes,
              "us_total": sum(passes.values())})
        del xs
    gen = torch.Generator(device="cuda").manual_seed(1)
    sums = {}
    for task, path, n, m in (leaves() if "int8" in args.only else []):
        q, qr = (torch.randint(-127, 128, (n, m), generator=gen,
                               device="cuda", dtype=torch.int8)
                 for _ in range(2))
        w = torch.softmax(torch.randn((n,), generator=gen, device="cuda"), 0)
        for planes in (1, 2):
            extra = (qr, w * 1e-2) if planes == 2 else ()
            ms = device_ms(lambda: dc.int8_decompress_reduce(q, w, *extra),
                           flush, args.reps)
            key = (task, planes)
            sums[key] = sums.get(key, 0.0) + ms
            emit({"label": args.label, "kernel": "int8_decompress_reduce",
                  "leaf": path, "n": n, "m": m,
                  "planes": planes, "ms": ms})
    for (task, planes), ms in sums.items():
        emit({"label": args.label, "kernel": "int8_decompress_reduce",
              "leaf": f"{task} round", "planes": planes, "ms": ms})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
