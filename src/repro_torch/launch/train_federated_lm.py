"""Federated training of a transformer LM with K-decay, on the port.

The port of ``examples/train_federated_lm.py``, with the same flags plus
``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train_federated_lm \\
        --rounds 4 --device cpu                     # CPU-quick
    PYTHONPATH=src python -m repro_torch.launch.train_federated_lm \\
        --rounds 300 --layers 8 --d-model 768 --vocab 8192   # ~100M params

The model is ``--arch``'s reduced config resized by ``--layers``,
``--d-model`` and ``--vocab``, trained with ``FedAvgTrainer`` over
``make_lm_clients`` token streams (24 clients, 6 a round), through
``registry.loss_fn`` on the dense MoE path with ``use_kernel=False``, as
the reference trains. ``--checkpoint`` is refused until the checkpoint
port (ROADMAP A4).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.configs.base import FedConfig, RuntimeModelConfig
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.data import make_lm_clients
from repro_torch.device import resolve_device
from repro_torch.models import registry


def build(args):
    """(trainer, cfg, n_params) for parsed ``args``, as the reference's
    example builds them."""
    base = get_arch(args.arch).reduced()
    heads = max(base.num_heads, 4)
    cfg = dataclasses.replace(
        base, num_layers=args.layers, d_model=args.d_model,
        head_dim=args.d_model // heads, d_ff=4 * args.d_model,
        vocab_size=args.vocab)
    n_params = registry.param_count(cfg)
    data = make_lm_clients(np.random.default_rng(0), num_clients=24,
                           vocab=cfg.vocab_size, seq_len=args.seq)
    model_loss = registry.loss_fn(cfg, moe_path="dense")
    loss_fn = lambda p, b: model_loss(p, {"tokens": b["x"]})
    fed = FedConfig(total_clients=24, clients_per_round=6, rounds=args.rounds,
                    k0=args.k0, eta0=0.05, batch_size=8, loss_window=8,
                    k_schedule=args.k_schedule,
                    server_optimizer=args.server_optimizer,
                    aggregator=args.aggregator)
    rt = RuntimeModel(n_params * 32 / 1e6,
                      RuntimeModelConfig(beta_seconds=0.05),
                      fed.clients_per_round)
    device = resolve_device(args.device)
    params = registry.init(0, cfg, device=device)
    return FedAvgTrainer(loss_fn, params, data, fed, rt,
                         device=device), cfg, n_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--k0", type=int, default=8)
    ap.add_argument("--k-schedule", default="rounds",
                    choices=("fixed", "rounds", "error", "step", "cosine",
                             "dsgd"))
    ap.add_argument("--server-optimizer", default="avg",
                    choices=("avg", "fedadam", "fedavgm", "fedyogi"))
    ap.add_argument("--aggregator", default="mean",
                    choices=("mean", "kernel", "median", "trimmed_mean"))
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.checkpoint:
        raise SystemExit("[train_federated_lm] --checkpoint is not ported "
                         "yet: it comes with the checkpoint port (ROADMAP "
                         "A4)")

    trainer, cfg, n_params = build(args)
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"params={n_params:,} device={trainer.device.type}")
    h = trainer.run(args.rounds, verbose=False)
    for r in range(0, args.rounds, max(args.rounds // 10, 1)):
        print(f"round {h.rounds[r]:4d} K={h.k[r]:3d} "
              f"loss={h.train_loss[r]:.4f} simW={h.wall_clock_s[r]:.0f}s")
    print(f"final: loss={h.train_loss[-1]:.4f} (from {h.train_loss[0]:.4f}) "
          f"steps={h.sgd_steps[-1]} simW={h.wall_clock_s[-1]:.0f}s")
    return h


if __name__ == "__main__":
    main()
