"""Federated-training launcher driven by an ExperimentSpec, on the port
(``repro.launch.train``, the same flags plus ``--device``).

Two front doors, one composition root (``repro_torch.api.build``):

  * declarative — ``--spec examples/specs/local-int8-decayK.json`` plus any
    number of ``--set section.field=value`` dotted-path overrides;
  * legacy flags — the historical ``--arch/--rounds/--k-schedule/...``
    surface, translated into the same spec.

The resolved spec is printed before the run (and is itself valid ``--spec``
input). With ``--checkpoint`` the final state is saved with the spec
embedded; ``FederatedExperiment.restore(path)`` rebuilds the exact trainer.
The run is on the card unless ``--device cpu``. ``--sweep`` runs the
resolved spec as the base of a fleet (``launch.fleet.run_fleet``: packed,
or one point after another with ``--serial-sweep``; ``--share-k-grid``;
the leaderboard CSV to ``--sweep-csv``). The engine line prints the bucket
programs built beside the dispatches.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --spec examples/specs/local-int8-decayK.json --set fed.rounds=4 \\
        --device cpu --checkpoint runs/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --set data.kind=paper --set data.task=femnist \\
        --sweep fed.k0=7,8 --share-k-grid --sweep-csv build/sweep.csv
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.api import ExperimentSpec, build
from repro_torch.configs import ARCHS


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # --- declarative front door -------------------------------------
    ap.add_argument("--spec", default=None, metavar="FILE.json",
                    help="load a full ExperimentSpec; legacy flags below "
                         "are ignored except --rounds/--checkpoint")
    ap.add_argument("--set", action="append", default=[], metavar="PATH=V",
                    dest="overrides",
                    help="dotted-path spec override, repeatable "
                         "(e.g. --set fed.k0=4 --set transport.name=int8)")
    ap.add_argument("--sweep", nargs="+", default=[], metavar="PATH=V1,V2",
                    help="run a fleet over this sweep grid on top of the "
                         "resolved spec (e.g. --sweep fed.k0=2,4,8 "
                         "transport.name=none,int8)")
    ap.add_argument("--sweep-csv", default=None, metavar="FILE.csv",
                    help="with --sweep: write the fleet leaderboard CSV")
    ap.add_argument("--share-k-grid", action="store_true",
                    help="with --sweep: pin fed.k_grid0 to the grid's max "
                         "fed.k0 so k0 points share bucket programs")
    ap.add_argument("--serial-sweep", action="store_true",
                    help="with --sweep: run points one after another "
                         "instead of packed")
    # --- legacy flags (translated to a spec) ------------------------
    ap.add_argument("--arch", choices=sorted(ARCHS),
                    default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--rounds", type=int, default=None,
                    help="round count (also applies on top of --spec)")
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--clients-per-round", type=int, default=6)
    ap.add_argument("--k0", type=int, default=8)
    ap.add_argument("--eta0", type=float, default=0.05)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--k-schedule", default="rounds",
                    choices=("fixed", "rounds", "error", "step", "cosine", "dsgd"))
    ap.add_argument("--eta-schedule", default="fixed",
                    choices=("fixed", "rounds", "error", "step"))
    ap.add_argument("--k-quantize", action="store_true")
    ap.add_argument("--server-optimizer", default="avg",
                    choices=("avg", "fedadam", "fedavgm", "fedyogi"))
    ap.add_argument("--aggregator", default="mean",
                    choices=("mean", "kernel", "median", "trimmed_mean"))
    ap.add_argument("--transport", default="none",
                    choices=("none", "int8", "int8x2", "topk"),
                    help="client-delta wire codec")
    ap.add_argument("--topk-frac", type=float, default=0.1,
                    help="kept coordinate fraction for --transport topk")
    ap.add_argument("--downlink", default="none",
                    choices=("none", "int8", "int8x2", "topk", "adaptive"),
                    help="server broadcast codec: delta vs the last "
                         "broadcast reference ('adaptive' picks "
                         "skip/int8/int8x2 per round)")
    ap.add_argument("--ref-store", default="f32", choices=("f32", "q8"),
                    help="server-held downlink reference/residual store "
                         "(q8: two-level int8, ~2x less state)")
    ap.add_argument("--aggregation", default="sync",
                    choices=("sync", "async"),
                    help="server aggregation policy: round-synchronous "
                         "FedAvg or FedBuff-style async buffering on the "
                         "simulated event clock")
    ap.add_argument("--buffer-size", type=int, default=None,
                    help="async: apply the buffer after this many client "
                         "arrivals (default: the cohort size)")
    ap.add_argument("--staleness-weight", default="constant",
                    choices=("constant", "inv", "poly"),
                    help="async: per-arrival contribution scale vs "
                         "staleness s — 1, 1/(1+s), or (1+s)^-0.5")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="async: drop arrivals staler than this many "
                         "versions (default: keep all)")
    ap.add_argument("--sampler", default="uniform",
                    choices=("uniform", "weighted", "fixed_cohort",
                             "availability"),
                    help="client participation policy")
    ap.add_argument("--availability", type=float, default=0.9,
                    help="per-round online probability for "
                         "--sampler availability")
    ap.add_argument("--backend", default="local", choices=("local", "mesh"),
                    help="execution backend: single-device or GSPMD mesh")
    ap.add_argument("--strategy", default="parallel",
                    choices=("parallel", "sequential"),
                    help="mesh client fan-out (ignored for --backend local)")
    ap.add_argument("--groups", type=int, default=1,
                    help="sequential-strategy client groups (hierarchical FL)")
    ap.add_argument("--bucket-rounds", type=int, default=8,
                    help="max rounds per jitted K-bucket scan")
    ap.add_argument("--feedback-bucket", type=int, default=1,
                    help="bucket length for error/step schedules")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the background batch prefetch thread")
    ap.add_argument("--serve-every", type=int, default=None,
                    help="serve-while-training: hot-swap the global model "
                         "into a live decode service and tick it every N "
                         "rounds / buffer applies (also applies on top "
                         "of --spec)")
    ap.add_argument("--serve-qps", type=float, default=None,
                    help="modelled decode queries/sec the server answers "
                         "alongside training (stretches the round clock by "
                         "1/(1-rho); also applies on top of --spec)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def spec_from_legacy_args(args) -> ExperimentSpec:
    """Translate the historical flag surface into an ExperimentSpec, the
    reference's translation (the ``loss_window = max(rounds // 8, 3)`` rule
    and the beta = 0.05 s runtime constant included)."""
    rounds = args.rounds if args.rounds is not None else 50
    # Optional async knobs only override when set: the spec refuses
    # buffer_size/max_staleness under aggregation="sync", and None is not
    # expressible as a dotted-path literal.
    async_overrides = [f"fed.aggregation={args.aggregation}",
                       f"fed.staleness_weight={args.staleness_weight}"]
    if args.buffer_size is not None:
        async_overrides.append(f"fed.buffer_size={args.buffer_size}")
    if args.max_staleness is not None:
        async_overrides.append(f"fed.max_staleness={args.max_staleness}")
    return ExperimentSpec().with_overrides(
        f"model.arch={args.arch}", f"model.reduced={args.reduced}",
        f"data.clients={args.clients}", f"data.seq_len={args.seq}",
        f"data.seed={args.seed}",
        f"fed.rounds={rounds}",
        f"fed.clients_per_round={args.clients_per_round}",
        f"fed.k0={args.k0}", f"fed.eta0={args.eta0}",
        f"fed.batch_size={args.batch_size}",
        f"fed.loss_window={max(rounds // 8, 3)}",
        f"fed.k_schedule={args.k_schedule}",
        f"fed.eta_schedule={args.eta_schedule}",
        f"fed.k_quantize={args.k_quantize}",
        f"fed.server_optimizer={args.server_optimizer}",
        f"fed.aggregator={args.aggregator}",
        f"fed.bucket_rounds={args.bucket_rounds}",
        f"fed.feedback_bucket_rounds={args.feedback_bucket}",
        f"fed.prefetch={not args.no_prefetch}",
        f"fed.seed={args.seed}",
        f"sampler.name={args.sampler}",
        f"sampler.availability={args.availability}",
        f"transport.name={args.transport}",
        f"transport.topk_frac={args.topk_frac}",
        f"transport.downlink={args.downlink}",
        f"transport.ref_store={args.ref_store}",
        f"backend.name={args.backend}", f"backend.strategy={args.strategy}",
        f"backend.groups={args.groups}",
        "runtime.beta_seconds=0.05",
        *async_overrides)


def resolve_spec(args) -> ExperimentSpec:
    if args.spec:
        spec = ExperimentSpec.load(args.spec)
        if args.rounds is not None:
            spec = spec.with_overrides(f"fed.rounds={args.rounds}")
    else:
        spec = spec_from_legacy_args(args)
    if args.overrides:
        spec = spec.with_overrides(*args.overrides)
    if args.serve_every is not None:
        spec = spec.with_overrides(f"serve.every={args.serve_every}")
    if args.serve_qps is not None:
        spec = spec.with_overrides(f"serve.qps={args.serve_qps}")
    return spec


def main(argv=None):
    args = make_parser().parse_args(argv)
    spec = resolve_spec(args).validate()
    if args.sweep:
        from repro_torch.launch.fleet import run_fleet
        result = run_fleet(spec, args.sweep, packed=not args.serial_sweep,
                           rounds=args.rounds, share_grid=args.share_k_grid,
                           verbose=True, device=args.device)
        print(result.leaderboard())
        if args.sweep_csv:
            result.to_csv(args.sweep_csv)
            print(f"[train] fleet csv -> {args.sweep_csv}")
        return result
    print("[train] resolved spec:")
    print(spec.to_json())

    exp = build(spec, device=args.device)
    trainer = exp.trainer
    rounds = spec.fed.rounds
    print(f"[train] {exp.label}: K-schedule={spec.fed.k_schedule}, "
          f"eta-schedule={spec.fed.eta_schedule}, "
          f"sampler={spec.sampler.name}, backend={spec.backend.name}")
    if spec.fed.aggregation == "async":
        print(f"[train] aggregation=async: buffer_size="
              f"{trainer.buffer_size}, "
              f"staleness_weight={spec.fed.staleness_weight}, "
              f"max_staleness={spec.fed.max_staleness}")
    engine = getattr(trainer, "engine", None)   # the sync trainer's
    transport = engine.transport if engine is not None else trainer.transport
    rt = trainer.runtime
    if transport is not None:
        ef = transport.ef_slots
        print(f"[train] transport={spec.transport.name}: uplink "
              f"{rt.uplink_compression:.2f}x compressed "
              f"({rt.uplink_mbit_per_client:.2f} of {rt.size:.2f} mbit "
              f"per client-round)"
              + (f", per-client EF x{ef}" if ef else ""))
    if engine is not None and engine.downlink is not None:
        print(f"[train] downlink={spec.transport.downlink}: broadcast "
              f"{rt.downlink_compression:.2f}x compressed "
              f"({rt.downlink_mbit_per_client:.2f} of {rt.size:.2f} mbit "
              f"per client-round)")

    h = exp.run()
    print(f"[train] engine[{spec.backend.name}]: {trainer.compile_count} "
          f"bucket program(s) built, {trainer.dispatch_count} "
          f"dispatch(es) for {rounds} rounds ({trainer.device.type})")
    if spec.fed.aggregation == "async":
        print(f"[train] async: {trainer.applied_updates} updates applied, "
              f"{trainer.dropped_updates} dropped, mean staleness "
              f"{float(np.mean(h.staleness)) if h.staleness else 0.0:.2f}, "
              f"event-clock wall {h.wall_clock_s[-1]:.0f}s")
    step = max(rounds // 10, 1)
    for i in range(0, rounds, step):
        print(f"[train] round {h.rounds[i]:4d} K={h.k[i]:3d} "
              f"eta={h.eta[i]:.4f} loss={h.train_loss[i]:.4f} "
              f"simW={h.wall_clock_s[i]:.0f}s steps={h.sgd_steps[i]}")
    if spec.serve.every and h.serve_rounds:
        print(f"[train] serve: {len(h.serve_rounds)} tick(s), "
              f"{float(np.mean(h.serve_tokens_per_sec)):.0f} tok/s mean, "
              f"swap {float(np.mean(h.serve_swap_us)):.0f}us mean, "
              f"staleness <= {max(h.serve_staleness)}, "
              f"served version {trainer.serving.served_version} of "
              f"{trainer.store.version}")
    print(f"[train] final loss {h.train_loss[-1]:.4f} "
          f"(start {h.train_loss[0]:.4f}); total steps {h.sgd_steps[-1]}, "
          f"simulated wall-clock {h.wall_clock_s[-1]:.0f}s, "
          f"uplink {h.uplink_mbit[-1]:.0f} mbit, "
          f"downlink {h.downlink_mbit[-1]:.0f} mbit")
    if args.checkpoint:
        exp.save(args.checkpoint)
        print(f"[train] checkpoint (spec embedded) -> {args.checkpoint}")
    return exp


if __name__ == "__main__":
    main()
