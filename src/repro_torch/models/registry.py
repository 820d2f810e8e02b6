"""Unified model API over the architectures the port runs (dense, MoE, SSM
and hybrid LMs), the names of ``repro.models.registry``:

    init(seed_or_generator, cfg, dtype, device) -> params
    loss_fn(cfg)(params, batch)                 -> (scalar, metrics)
    forward_fn(cfg)(params, batch)              -> (logits, aux)
    init_cache(params, cfg, batch, seq)         -> decode cache
    decode_fn(cfg)(params, cache, token, pos)   -> (logits, cache)
    param_count(cfg)                            -> int (no allocation)

``init`` draws from an explicit ``torch.Generator`` with the reference's
distributions (lecun-normal kernels, embedding stddev d^-0.5, zero biases,
unit norm scales); ``jax.random`` streams cannot be replayed, so tests hand
the reference's values over through ``bridge.params_from_jax``.
"""
from __future__ import annotations

import functools
from typing import Any, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.optim import tree_leaves

PyTree = Any

# long-context mode: cap on "global" layers' attention span
LONG_GLOBAL_WINDOW = 32768


def _generator(seed_or_generator: Union[int, torch.Generator]):
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


def init(seed_or_generator: Union[int, torch.Generator], cfg: ArchConfig,
         dtype=torch.float32, device: DeviceLike = None) -> PyTree:
    """Params on ``device`` (default ``cuda``), drawn on the CPU from the
    generator (a seed makes one), so one seed gives the same weights on
    every device."""
    return transformer.init_lm(_generator(seed_or_generator), cfg, dtype,
                               resolve_device(device))


def loss_fn(cfg: ArchConfig, *, remat: bool = False,
            moe_path: str = "dispatch", use_kernel: bool = False):
    transformer.require_ported(cfg)

    def fn(params, batch):
        return transformer.loss_lm(params, cfg, batch, remat=remat,
                                   moe_path=moe_path, use_kernel=use_kernel)
    return fn


def forward_fn(cfg: ArchConfig, *, long_mode: bool = False,
               moe_path: str = "dispatch", use_kernel: bool = False):
    transformer.require_ported(cfg)
    gw = LONG_GLOBAL_WINDOW if long_mode else None

    def fn(params, batch):
        return transformer.forward_lm(params, cfg, batch["tokens"],
                                      global_window=gw, moe_path=moe_path,
                                      use_kernel=use_kernel)
    return fn


def init_cache(params, cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, *, ring: bool = False,
               long_mode: bool = False, quant: bool = False):
    """A zeroed decode cache on the device of ``params``."""
    gw = LONG_GLOBAL_WINDOW if long_mode else None
    return transformer.init_cache_lm(
        cfg, batch, max_seq, dtype, ring=ring, global_window=gw, quant=quant,
        device=params["embed"]["embedding"].device)


def decode_fn(cfg: ArchConfig, *, long_mode: bool = False,
              moe_path: str = "dispatch", ring: bool = False):
    transformer.require_ported(cfg)
    gw = LONG_GLOBAL_WINDOW if long_mode else None

    def fn(params, cache, token, pos):
        return transformer.decode_step_lm(params, cfg, cache, token, pos,
                                          global_window=gw, moe_path=moe_path,
                                          ring=ring)
    return fn


# ---------------------------------------------------------------------------
# parameter counting (the runtime model needs |x|)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``, counted from shapes on the ``meta`` device
    (nothing drawn, nothing allocated)."""
    shapes = transformer.init_lm(None, cfg, device="meta")
    return int(sum(t.numel() for t in tree_leaves(shapes)))


def active_param_count(cfg: ArchConfig) -> int:
    """MoE: params touched per token (top-k of E experts); dense: all."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    expert_params = 3 * cfg.d_model * cfg.d_ff * E * cfg.num_layers
    return total - expert_params + expert_params * k // E
