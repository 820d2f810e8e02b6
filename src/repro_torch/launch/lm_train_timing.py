"""Where a round of federated LM training spends its time on the card.

    PYTHONPATH=src python3 src/repro_torch/launch/lm_train_timing.py \\
        [--config a|b|c|d] [--rounds 2]

Trains qwen1.5-0.5b at full width (f32, seed 0, TF32 off) with
``FedAvgTrainer`` at the LM specs' traffic (``chip_smoke.py``'s phase
``lm_train``: 12 clients of ``make_lm_clients`` tokens, 4 a round, b 4, seq
32, K_r-rounds) in one of its configurations: (a) int8 uplink, (b) int8
both ways, (c) a fixed cohort with top-k 0.25, (d) no codec, the kernel
aggregator. After one warm-up round it runs ``--rounds`` rounds twice:
under the host clock alone, then under ``torch.profiler`` (CPU and CUDA).
It prints the card (``nvidia-smi``'s name and power limit), then one JSON
line with

- ``ms_per_round`` (host clock, synchronised; the unprofiled run) and the
  profiled run's;
- ``device_busy_ms_per_round``: the sum of every kernel's device time in
  the profiled run, a round; ``device_busy_share`` that sum over the
  profiled run's wall time (one stream, so kernels do not overlap);
- ``kernel_launches_per_round`` (``cudaLaunchKernel`` and friends the
  profiler saw), ``launches_per_local_step`` and the host µs a launch;
- the twelve kernels with the most device time, ms a round.

``TRAFFIC``, ``CONFIGS``, ``lm_data`` and ``make_trainer`` define that
cell for ``chip_smoke.py`` and the card tests too.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import FedConfig, get_arch
from repro_torch.configs.base import RuntimeModelConfig
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.data import make_lm_clients
from repro_torch.device import resolve_device
from repro_torch.models import registry

# the traffic of examples/specs/local-int8-decayK.json and its siblings
TRAFFIC = dict(total_clients=12, clients_per_round=4, eta0=0.05,
               batch_size=4, k_schedule="rounds", loss_window=5,
               bucket_rounds=8, seed=0)
SEQ, BETA = 32, 0.05
CONFIGS = {"a": dict(k0=8, transport="int8"),
           "b": dict(k0=8, transport="int8", downlink="int8"),
           "c": dict(k0=6, transport="topk", topk_frac=0.25,
                     sampler="fixed_cohort", cohort=(0, 3, 5, 9)),
           "d": dict(k0=8, aggregator="kernel")}
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernel", "cudaLaunchCooperativeKernel")


def lm_data(cfg):
    """The clients' tokens: ``make_lm_clients(default_rng(0), 12,
    cfg.vocab_size, SEQ)``."""
    return make_lm_clients(np.random.default_rng(0),
                           TRAFFIC["total_clients"], vocab=cfg.vocab_size,
                           seq_len=SEQ)


def make_trainer(config: str, rounds: int, cfg, params, data, device=None,
                 moe_path: str = "dispatch", backend=None) -> FedAvgTrainer:
    """``FedAvgTrainer`` at ``TRAFFIC`` in ``CONFIGS[config]``, built as
    ``repro/api/experiment.py:83-97`` builds the reference's: the clients'
    loss is ``registry.loss_fn(cfg)`` (``use_kernel=False``) on the batch's
    x; |x| is the params at 4 bytes, beta ``BETA``; ``backend``: an
    ``ExecutionBackend`` (default ``LocalBackend``)."""
    fed = FedConfig(rounds=rounds, **TRAFFIC, **CONFIGS[config])
    model_loss = registry.loss_fn(cfg, moe_path=moe_path)
    rt = RuntimeModel(registry.param_count(cfg) * 4 * 8 / 1e6,
                      RuntimeModelConfig(beta_seconds=BETA),
                      fed.clients_per_round)
    return FedAvgTrainer(lambda p, b: model_loss(p, {"tokens": b["x"]}),
                         params, data, fed, rt, device=device,
                         backend=backend)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=sorted(CONFIGS), default="d")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    device = resolve_device(None)                   # the card, or raise
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    cfg = get_arch("qwen1.5-0.5b")
    trainer = make_trainer(args.config, args.rounds, cfg,
                           registry.init(0, cfg, device=device),
                           lm_data(cfg), device)
    trainer.run(1)                                  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    h = trainer.run(args.rounds)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    ks = h.k[-args.rounds:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.run(args.rounds)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t
    events = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in events if e.self_device_time_total > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda x: -x[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    launch_host_us = sum(e.self_cpu_time_total for e in events
                         if e.key in LAUNCH_CALLS)
    r = args.rounds
    out = {"config": args.config, "fed": CONFIGS[args.config],
           "device": torch.cuda.get_device_name(0),
           "rounds": r, "k": ks,
           "ms_per_round": plain_s * 1e3 / r,
           "profiled_ms_per_round": prof_s * 1e3 / r,
           "device_busy_ms_per_round": busy_ms / r,
           "device_busy_share": busy_ms / (prof_s * 1e3),
           "kernel_launches_per_round": launches / r,
           "launches_per_local_step": launches / sum(ks),
           "host_us_per_launch_call": (launch_host_us / launches
                                       if launches else None),
           "top_kernels_ms_per_round": [
               {"name": name[:120], "ms": ms / r, "calls": n // r}
               for name, ms, n in kernels[:12]]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
