"""Host and device time of the FedAvg aggregation's entry points on the card.

Compares two checkouts of the port on one card: run it once for each, in
turns, with ``PYTHONPATH`` naming the checkout's ``src`` (the script uses
only entry points that every version of the port has)::

    PYTHONPATH=<checkout>/src python3 \
        src/repro_torch/launch/aggregation_timing.py --label <name>

It prints the card (``nvidia-smi``'s name and power limit), then one JSON
line for each of:

- ``fedavg_reduce_tree`` on each paper task's client-stacked tree at its
  paper N, and ``fedavg_reduce`` on each of its leaves (summed): the
  host's time for one call with the card idle (``host_ms``), and the
  device time from CUDA events around the call after a 256 MB write to
  flush L2 (``ms``, the method of ``chip_smoke.py``), and after the same
  flush and a ~1 ms spin kernel (``ms_spin``): the host has then enqueued
  the call before the card reaches it, so the events see device time
  only, however long the host takes;
- ``int8_decode_apply`` at the CIFAR100 ``fc`` leaf, one and two planes,
  the same three times;
- the main path: ``FedAvgTrainer(aggregator="kernel")`` on each paper
  task at its paper configuration for the rounds of ``ROUNDS``, with the host
  time of each round's ``fedavg_reduce_tree`` call (``reduce_host_ms``)
  and CUDA events around it (``reduce_ms``).

Medians of ``--reps`` calls.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch

TASKS = ("cifar100", "femnist", "sent140", "shakespeare")
# rounds of the main path for each task (Shakespeare's GRU takes ~12 s a
# round on the H100)
ROUNDS = {"cifar100": 2, "femnist": 2, "sent140": 2, "shakespeare": 1}
# cycles of the spin kernel: ~1 ms at the H100's 1.98 GHz
SPIN_CYCLES = 2_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, flush, reps: int, spin: bool) -> float:
    """Median device time of one call (CUDA events), L2 flushed by a write
    before each; ``spin`` puts ``SPIN_CYCLES`` of a spin kernel between
    the flush and the call."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def host_ms(fn, reps: int) -> float:
    """Median host time of one call, the card idle before each."""
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


def times(fn, flush, reps: int) -> dict:
    return {"host_ms": host_ms(fn, reps),
            "ms": device_ms(fn, flush, reps, spin=False),
            "ms_spin": device_ms(fn, flush, reps, spin=True)}


def tree_rows(label: str, flush, reps: int) -> None:
    from repro_torch.configs import get_paper_task
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.models import small
    from repro_torch.optim import tree_leaves, tree_map
    gen = torch.Generator(device="cuda").manual_seed(0)
    for task in TASKS:
        cfg = get_paper_task(task)
        n = cfg.fed.clients_per_round
        params = small.init_task_model(0, cfg, device="cpu")
        tree = tree_map(lambda p: torch.randn(
            (n,) + tuple(p.shape), generator=gen, device="cuda"), params)
        w = torch.softmax(torch.randn((n,), generator=gen, device="cuda"),
                          0)
        flats = [x.reshape(n, -1) for x in tree_leaves(tree)]
        before = fr.launches
        ops.fedavg_reduce_tree(tree, w)
        launches = fr.launches - before
        leaf = [times(lambda x=x: fr.fedavg_reduce(x, w), flush, reps)
                for x in flats]
        emit({"label": label, "what": "fedavg_reduce_tree", "task": task,
              "n": n, "leaves": len(flats), "launches": launches,
              "tree": times(lambda: ops.fedavg_reduce_tree(tree, w), flush,
                            reps),
              "per_leaf_sum": {k: sum(r[k] for r in leaf)
                               for k in ("host_ms", "ms", "ms_spin")},
              "per_leaf": [dict(m=x.shape[1], **r)
                           for x, r in zip(flats, leaf)]})


def apply_rows(label: str, flush, reps: int) -> None:
    from repro_torch.kernels import delta_codec as dc
    gen = torch.Generator(device="cuda").manual_seed(1)
    m = 2 ** 21     # the CIFAR100 fc leaf, 4096 x 512
    ref = torch.randn((m,), generator=gen, device="cuda")
    q = torch.randint(-127, 128, (2, m), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.full((1,), 3e-3, device="cuda")
    rs = torch.full((1,), 2e-5, device="cuda")
    for planes in (1, 2):
        args = (ref, q[0], s) + ((q[1], rs) if planes == 2 else ())
        emit({"label": label, "what": "int8_decode_apply", "shape": "fc",
              "m": m, "planes": planes,
              **times(lambda: dc.int8_decode_apply(*args), flush, reps)})


def main_path_rows(label: str) -> None:
    from repro_torch.configs import get_paper_task
    from repro_torch.core import FedAvgTrainer, RuntimeModel, make_eval_fn
    from repro_torch.data import make_paper_task
    from repro_torch.kernels import ops
    from repro_torch.models import small
    for task in TASKS:
        cfg = get_paper_task(task)
        rounds = ROUNDS[task]
        data = make_paper_task(task, np.random.default_rng(0))
        fed = dataclasses.replace(cfg.fed, k_schedule="rounds",
                                  aggregator="kernel", rounds=rounds)
        loss_fn = lambda p, b: small.task_loss(p, cfg, b)
        trainer = FedAvgTrainer(
            loss_fn, small.init_task_model(0, cfg), data, fed,
            RuntimeModel(cfg.model_size_mb, cfg.runtime,
                         fed.clients_per_round),
            make_eval_fn(loss_fn, data))
        host, events = [], []
        reduce_tree = ops.fedavg_reduce_tree

        def timed_reduce(*a):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            t = time.perf_counter()
            out = reduce_tree(*a)
            host.append((time.perf_counter() - t) * 1e3)
            ev[1].record()
            events.append(ev)
            return out

        ops.fedavg_reduce_tree = timed_reduce
        try:
            trainer.run(rounds, eval_every=rounds)
            torch.cuda.synchronize()
        finally:
            ops.fedavg_reduce_tree = reduce_tree
        emit({"label": label, "what": "main", "task": task,
              "rounds": rounds, "reduce_host_ms": host,
              "reduce_ms": [a.elapsed_time(b) for a, b in events]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True,
                    help="names the checkout in every line")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    flush = torch.empty(256 * 2 ** 20 // 4, device="cuda")  # > 50 MB L2
    tree_rows(args.label, flush, args.reps)
    apply_rows(args.label, flush, args.reps)
    del flush
    torch.cuda.empty_cache()
    main_path_rows(args.label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
