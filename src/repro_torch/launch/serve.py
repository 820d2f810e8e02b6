"""Batched serving launcher: greedy decode through the KV cache, built on
``GlobalModelStore`` + ``ServingLoop`` (``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --batch 4 --prompt-len 16 --tokens 32 [--device cpu]

Serves the reduced config of ``--arch`` (default zamba2-7b, as the
reference's) with params from ``--seed``, as the reference does without a
checkpoint; MoE archs (mixtral-8x22b, phi3.5-moe-42b-a6.6b) decode on the
serving loop's dense MoE path, every expert on every token, as the
reference serves them; SSM and hybrid archs decode through their SSM and
conv states. ``--checkpoint`` is refused until the checkpoint port lands.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, LATER_ARCHS, get_arch
from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.core.serve import ServingLoop
from repro_torch.device import resolve_device
from repro_torch.models import registry

DEFAULT_ARCH = "zamba2-7b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted({*ARCHS, *LATER_ARCHS}),
                    default=None,
                    help=f"architecture (default {DEFAULT_ARCH}), reduced")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.checkpoint:
        raise SystemExit("[serve] --checkpoint is not ported yet: it needs "
                         "the port of repro.checkpoint (ROADMAP item 7)")
    device = resolve_device(args.device)
    cfg = get_arch((args.arch or DEFAULT_ARCH) + "-reduced")
    params = registry.init(args.seed, cfg, device=device)
    store = GlobalModelStore(params=params)
    loop = ServingLoop(store, cfg, batch=args.batch,
                       prompt_len=args.prompt_len, tokens=args.tokens,
                       seed=args.seed)
    swap_us = loop.swap()
    ids, dt = loop.decode(loop._traffic(0))
    print(f"[serve] store snapshot v{loop.served_version} hot-swapped "
          f"in {swap_us:.0f}us")
    print(f"[serve] {cfg.name} ({cfg.arch_type}): batch={args.batch}, "
          f"{args.tokens} tokens/seq, {args.batch * args.tokens / dt:.1f} "
          f"tok/s ({device.type})")
    print(f"[serve] ids[0] = {ids[0].tolist()}")


if __name__ == "__main__":
    main()
