"""Quickstart: FedAvg with a decaying number of local SGD steps, on the
port (``examples/quickstart.py``, the same flags plus ``--device``).

Trains the paper's FEMNIST DNN on a synthetic non-IID federated split and
compares the K_r-rounds decay schedule (Eq. 10) against fixed-K, reporting
simulated wall-clock (the paper's Eq. 5 runtime model) and total compute.
The port runs eagerly, so where the reference prints its compile count this
prints the engine's dispatch count.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--rounds 60] \\
        [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_paper_task
from repro_torch.configs.base import FedConfig
from repro_torch.core import FedAvgTrainer, RuntimeModel, make_eval_fn
from repro_torch.data import make_paper_task
from repro_torch.device import resolve_device
from repro_torch.models import small


def main(argv=None):
    """Returns ``{"fixed": History, "rounds": History}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    task = get_paper_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=args.clients, samples_per_client=60)
    loss_fn = lambda p, b: small.task_loss(p, task, b)

    results = {}
    for schedule in ("fixed", "rounds"):
        fed = FedConfig(total_clients=args.clients, clients_per_round=10,
                        rounds=args.rounds, k0=16, eta0=0.3, batch_size=16,
                        loss_window=8, k_schedule=schedule)
        params = small.init_task_model(0, task, device=device)
        rt = RuntimeModel(task.model_size_mb, task.runtime, 10)
        trainer = FedAvgTrainer(loss_fn, params, data, fed, rt,
                                eval_fn=make_eval_fn(loss_fn, data,
                                                     device=device),
                                device=device)
        print(f"\n=== schedule: K_r-{schedule} ===")
        h = trainer.run(args.rounds, eval_every=10, verbose=True)
        results[schedule] = h

        print(f"    ({trainer.dispatch_count} dispatch(es) for "
              f"{args.rounds} rounds)")

    f, d = results["fixed"], results["rounds"]
    print("\n=== summary (paper's headline claim) ===")
    print(f"fixed-K : loss={f.min_train_loss[-1]:.4f} "
          f"acc={f.max_val_acc[-1]:.3f} simW={f.wall_clock_s[-1]:.0f}s "
          f"steps={f.sgd_steps[-1]}")
    print(f"K-decay : loss={d.min_train_loss[-1]:.4f} "
          f"acc={d.max_val_acc[-1]:.3f} simW={d.wall_clock_s[-1]:.0f}s "
          f"steps={d.sgd_steps[-1]}")
    print(f"compute saved: {1 - d.sgd_steps[-1] / f.sgd_steps[-1]:.0%}, "
          f"wall-clock saved: {1 - d.wall_clock_s[-1] / f.wall_clock_s[-1]:.0%}")
    return results


if __name__ == "__main__":
    main()
