"""ServingLoop: the global model as a live greedy-decode service
(``repro.core.serve.loop``).

The loop pulls ``GlobalModelStore.snapshot()`` (the tree clients hold),
hot-swaps it under the decode step, and replays a deterministic traffic
stream against it: each ``tick`` takes one batch of prompts, a pure
function of ``(seed, tick)``, runs teacher-forced prefill through the
decode path, then greedy decode through the decode cache (KV caches, and
SSM and conv states for mamba layers), and records
tokens/s, swap latency and staleness into ``History``.

Traffic streams are a plain name -> factory dict (``TRAFFIC``); the
``synthetic`` stream draws uniform prompt ids from a numpy rng seeded
``[seed, tick]``, draw for draw the reference's.
"""
from __future__ import annotations

import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine.model_store import GlobalModelStore
from repro_torch.models import registry

PyTree = Any


def _synthetic_traffic(*, cfg, batch: int, prompt_len: int, seed: int = 0):
    """Uniform prompt ids; each tick's batch is a pure function of
    ``(seed, tick)``, so the stream replays identically."""
    def prompts(tick: int) -> np.ndarray:
        rng = np.random.default_rng([int(seed), int(tick)])
        return rng.integers(0, cfg.vocab_size,
                            size=(batch, prompt_len)).astype(np.int32)
    return prompts


TRAFFIC = {"synthetic": _synthetic_traffic}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingLoop:
    """Hot-swaps ``store.snapshot()`` under the decode step and replays
    deterministic traffic against the served version. Runs where the
    store's params live; MoE layers decode on ``moe_path`` (every expert
    on every token by default, as the reference's loop)."""

    def __init__(self, store: GlobalModelStore, cfg, *, batch: int = 2,
                 prompt_len: int = 4, tokens: int = 8,
                 moe_path: str = "dense", traffic: str = "synthetic",
                 seed: int = 0):
        if cfg.arch_type == "audio":
            raise ValueError(
                f"arch {cfg.name!r} is an audio encoder-decoder: its decode "
                f"cache needs per-query audio embeddings, which the "
                f"synthetic serving loop does not model")
        if traffic not in TRAFFIC:
            raise ValueError(f"unknown traffic {traffic!r}: one of "
                             f"{sorted(TRAFFIC)}")
        self.store = store
        self.cfg = cfg
        self.batch = int(batch)
        self.prompt_len = int(prompt_len)
        self.tokens = int(tokens)
        self._step = registry.decode_fn(cfg, moe_path=moe_path)
        self._traffic = TRAFFIC[traffic](cfg=cfg, batch=self.batch,
                                         prompt_len=self.prompt_len, seed=seed)
        self.params: PyTree = None
        self.served_version = -1
        self.ticks = 0
        self.total_tokens = 0
        self.swap()

    def swap(self) -> float:
        """Publish the store's current snapshot to the service; returns the
        swap latency in µs (snapshot + dequantise, finished on the device)."""
        t0 = time.perf_counter()
        version, tree = self.store.snapshot()
        _sync(tree["embed"]["embedding"].device)
        us = (time.perf_counter() - t0) * 1e6
        self.params = tree
        self.served_version = version
        return us

    @torch.no_grad()
    def decode(self, prompt_ids,
               params: Optional[PyTree] = None) -> Tuple[torch.Tensor, float]:
        """One traffic replay: teacher-forced prefill through the decode
        path, then greedy decode of ``self.tokens`` tokens. Returns the
        (batch, tokens) generated ids and the decode seconds (the prefill
        is excluded, as in the reference)."""
        params = self.params if params is None else params
        dev = params["embed"]["embedding"].device
        prompt = torch.as_tensor(np.asarray(prompt_ids), device=dev)
        cache = registry.init_cache(params, self.cfg, prompt.shape[0],
                                    self.prompt_len + self.tokens)
        for pos in range(self.prompt_len):
            logits, cache = self._step(params, cache, prompt[:, pos], pos)
        tok = torch.argmax(logits, dim=-1)
        out = []
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(self.tokens):
            logits, cache = self._step(params, cache, tok,
                                       self.prompt_len + i)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        _sync(dev)
        dt = time.perf_counter() - t0
        return torch.stack(out, dim=1), dt

    def tick(self, round_idx: int, history=None) -> float:
        """One serving tick at round ``round_idx``: measure how stale the
        served version got, hot-swap the fresh snapshot, replay one traffic
        batch against it. Returns tokens/s."""
        staleness = self.store.version - self.served_version
        swap_us = self.swap()
        _, dt = self.decode(self._traffic(self.ticks))
        tps = self.batch * self.tokens / max(dt, 1e-9)
        self.ticks += 1
        self.total_tokens += self.batch * self.tokens
        if history is not None:
            history.serve_rounds.append(int(round_idx))
            history.serve_tokens_per_sec.append(float(tps))
            history.serve_swap_us.append(float(swap_us))
            history.serve_staleness.append(int(staleness))
        return tps
