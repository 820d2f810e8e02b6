"""Batched serving launcher: greedy decode through the KV cache, built on
``GlobalModelStore`` + ``ServingLoop`` (``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --batch 4 --prompt-len 16 --tokens 32 [--checkpoint DIR] [--device cpu]

Without ``--checkpoint`` it serves the reduced config of ``--arch``
(default zamba2-7b, as the reference's) with params from ``--seed``. With
one, trainer checkpoints (of either package) embed their ``ExperimentSpec``,
so the model is rebuilt from the spec inside the checkpoint and its
``params/`` loaded; an explicitly conflicting ``--arch`` errors instead of
decoding through the wrong architecture. A checkpoint without a spec (bare
params, or a trainer layout) takes the reduced ``--arch``. MoE archs decode
on the serving loop's dense MoE path, every expert on every token, as the
reference serves them; SSM and hybrid archs decode through their SSM and
conv states; ``llava-next-34b`` serves text only, as the reference's. The
encoder-decoder ``whisper-tiny`` decodes directly through
``registry.init_cache(..., audio_embeds=...)`` (``decode_audio``): the
serving loop's synthetic traffic has no audio, so it refuses audio archs.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.engine.model_store import (GlobalModelStore,
                                                 as_spec_tree)
from repro_torch.core.serve import ServingLoop
from repro_torch.device import resolve_device
from repro_torch.models import registry

DEFAULT_ARCH = "zamba2-7b"


def load_serving_params(path: str, arch_arg=None, device=None):
    """(cfg, params) from a checkpoint directory, the params on ``device``
    (default ``cuda``).

    Spec-embedded checkpoints (what ``FederatedExperiment.save`` writes)
    rebuild the model from the spec; the stored tree keeps params under
    ``params/`` beside the server, transport and downlink state. Others
    take ``arch_arg`` (reduced) and accept a bare-params or a prefixed
    layout. The load's template is built on the ``meta`` device, so no
    params are drawn to be thrown away."""
    meta_path = os.path.join(path, "meta.json")
    if not os.path.isfile(meta_path):
        raise SystemExit(f"[serve] --checkpoint {path!r}: no checkpoint "
                         f"there ({meta_path} is missing)")
    with open(meta_path) as f:
        meta = json.load(f)
    device = resolve_device(device)
    if "spec" in meta:
        from repro_torch.api import ExperimentSpec
        spec = ExperimentSpec.from_dict(meta["spec"])
        if spec.data.kind != "lm":
            raise SystemExit(
                f"[serve] checkpoint {path!r} trained data.kind="
                f"{spec.data.kind!r} (a paper-task model, not an LM) — "
                f"there is no decode path to serve it")
        if arch_arg is not None and arch_arg != spec.model.arch:
            raise SystemExit(
                f"[serve] --arch {arch_arg!r} conflicts with the "
                f"checkpoint's embedded spec (model.arch="
                f"{spec.model.arch!r}, reduced={spec.model.reduced}); "
                f"drop --arch — the model is rebuilt from the spec")
        cfg = get_arch(spec.model.arch)
        if spec.model.reduced:
            cfg = cfg.reduced()
        like = as_spec_tree(registry.shapes(cfg), device)
        tree, _ = load_checkpoint(path, {"params": like})
        print(f"[serve] rebuilt {spec.model.arch} "
              f"(reduced={spec.model.reduced}) from the checkpoint's "
              f"embedded spec, round {meta.get('completed_rounds', '?')}")
        return cfg, tree["params"]
    cfg = get_arch(arch_arg or DEFAULT_ARCH).reduced()
    like = as_spec_tree(registry.shapes(cfg), device)
    try:
        params, _ = load_checkpoint(path, like)
    except KeyError:
        # a trainer layout without a spec: params under "params/"
        params = load_checkpoint(path, {"params": like})[0]["params"]
    print(f"[serve] restored a checkpoint without an embedded spec (arch "
          f"{cfg.name} taken from --arch)")
    return cfg, params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def decode_audio(params, cfg, *, batch: int, prompt_len: int, tokens: int,
                 seed: int = 0):
    """The encoder-decoder's direct decode (the reference's audio branch):
    audio embeddings drawn N(0, 0.1^2) from ``seed`` and uniform prompt ids
    from seed 1 (torch's streams, not ``jax.random``'s), the encoder run
    once into the cache, teacher-forced prefill through the decode step,
    then greedy decode of ``tokens`` tokens. Returns the (batch, tokens)
    ids, the decode seconds (the prefill excluded) and each generated
    step's (batch, vocab) logits."""
    dev = params["embed"]["embedding"].device
    audio = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                        generator=torch.Generator().manual_seed(seed)) * 0.1
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(1))
    cache = registry.init_cache(params, cfg, batch, prompt_len + tokens,
                                audio_embeds=audio.to(dev))
    step = registry.decode_fn(cfg, moe_path="dense")
    prompt = prompt.to(dev)
    for pos in range(prompt_len):
        logits, cache = step(params, cache, prompt[:, pos], pos)
    tok = torch.argmax(logits, dim=-1)
    out, steps = [], []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(tokens):
        logits, cache = step(params, cache, tok, prompt_len + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        steps.append(logits)
    _sync(dev)
    return (torch.stack(out, dim=1), time.perf_counter() - t0,
            torch.stack(steps, dim=1))


def main(argv=None):
    """Returns ``{"cfg", "params" (the served snapshot), "ids",
    "tokens_per_s"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS),
                    default=None,
                    help=f"architecture (default {DEFAULT_ARCH}), reduced; "
                         f"ignored, and checked for conflicts, when "
                         f"--checkpoint embeds a spec")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.checkpoint:
        cfg, params = load_serving_params(args.checkpoint, args.arch,
                                          device=args.device)
        device = resolve_device(args.device)
    else:
        device = resolve_device(args.device)
        cfg = get_arch((args.arch or DEFAULT_ARCH) + "-reduced")
        params = registry.init(args.seed, cfg, device=device)
    if registry.is_encdec(cfg):
        ids, dt, _ = decode_audio(params, cfg, batch=args.batch,
                                  prompt_len=args.prompt_len,
                                  tokens=args.tokens, seed=args.seed)
    else:
        store = GlobalModelStore(params=params)
        loop = ServingLoop(store, cfg, batch=args.batch,
                           prompt_len=args.prompt_len, tokens=args.tokens,
                           seed=args.seed)
        swap_us = loop.swap()
        ids, dt = loop.decode(loop._traffic(0))
        params = loop.params
        print(f"[serve] store snapshot v{loop.served_version} hot-swapped "
              f"in {swap_us:.0f}us")
    tps = args.batch * args.tokens / dt
    print(f"[serve] {cfg.name} ({cfg.arch_type}): batch={args.batch}, "
          f"{args.tokens} tokens/seq, {tps:.1f} tok/s ({device.type})")
    print(f"[serve] ids[0] = {ids[0].tolist()}")
    return {"cfg": cfg, "params": params, "ids": ids,
            "tokens_per_s": tps}


if __name__ == "__main__":
    main()
