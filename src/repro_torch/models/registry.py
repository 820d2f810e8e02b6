"""Unified model API over every architecture family (dense, MoE, SSM,
hybrid and vision-language LMs, and the audio encoder-decoder), the names
of ``repro.models.registry``:

    init(seed_or_generator, cfg, dtype, device) -> params
    loss_fn(cfg)(params, batch)                 -> (scalar, metrics)
    forward_fn(cfg)(params, batch)              -> (logits, aux)
    init_cache(params, cfg, batch, seq[, audio_embeds=, mesh=]) -> decode cache
    decode_fn(cfg)(params, cache, token, pos)   -> (logits, cache)
    shapes(cfg, dtype)                          -> params on ``meta``
    cache_specs(cfg, batch, seq)                -> a decode cache on ``meta``
    input_specs(cfg, shape)                     -> {name: TensorSpec}
    param_count(cfg)                            -> int (no allocation)

``init`` draws from an explicit ``torch.Generator`` with the reference's
distributions (lecun-normal kernels, embedding stddev d^-0.5, zero biases,
unit norm scales); ``jax.random`` streams cannot be replayed, so tests hand
the reference's values over through ``bridge.params_from_jax``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.optim import tree_leaves

PyTree = Any

# long-context mode: cap on "global" layers' attention span
LONG_GLOBAL_WINDOW = 32768


def _generator(seed_or_generator: Union[int, torch.Generator]):
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.arch_type == "audio"


def init(seed_or_generator: Union[int, torch.Generator], cfg: ArchConfig,
         dtype=torch.float32, device: DeviceLike = None) -> PyTree:
    """Params on ``device`` (default ``cuda``), drawn on the generator's
    device (a seed makes a CPU generator, so one seed gives the same
    weights on every device)."""
    make = encdec.init_encdec if is_encdec(cfg) else transformer.init_lm
    return make(_generator(seed_or_generator), cfg, dtype,
                resolve_device(device))


def loss_fn(cfg: ArchConfig, *, remat: bool = False,
            moe_path: str = "dispatch", use_kernel: bool = False,
            moe_shards: int = 1, moe_spmd_axes=None, tp=None):
    """batch: {tokens, [mask]} plus a vlm's ``patch_embeds`` or the
    encoder-decoder's ``audio_embeds``. ``tp``: the train step's
    ``"model"`` rank (``transformer.loss_lm``). The encoder-decoder runs
    no kernel and ignores ``moe_path``, ``use_kernel``, the MoE token
    groups (``moe_shards``, ``moe_spmd_axes``) and ``tp``, as the
    reference."""
    if is_encdec(cfg):
        def enc_fn(params, batch):
            return encdec.loss_encdec(params, cfg, batch, remat=remat)
        return enc_fn

    def fn(params, batch):
        return transformer.loss_lm(params, cfg, batch, remat=remat,
                                   moe_path=moe_path, use_kernel=use_kernel,
                                   moe_shards=moe_shards,
                                   moe_spmd_axes=moe_spmd_axes, tp=tp)
    return fn


def forward_fn(cfg: ArchConfig, *, long_mode: bool = False,
               moe_path: str = "dispatch", use_kernel: bool = False,
               moe_shards: int = 1, moe_spmd_axes=None):
    gw = LONG_GLOBAL_WINDOW if long_mode else None
    if is_encdec(cfg):
        def enc_fn(params, batch):
            return encdec.forward_encdec(params, cfg, batch["tokens"],
                                         batch["audio_embeds"])
        return enc_fn

    def fn(params, batch):
        return transformer.forward_lm(params, cfg, batch["tokens"],
                                      batch.get("patch_embeds"),
                                      global_window=gw, moe_path=moe_path,
                                      use_kernel=use_kernel,
                                      moe_shards=moe_shards,
                                      moe_spmd_axes=moe_spmd_axes)
    return fn


def init_cache(params, cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, audio_embeds=None, *,
               ring: bool = False, long_mode: bool = False,
               quant: bool = False, mesh=None):
    """A zeroed decode cache on the device of ``params``; the
    encoder-decoder's runs its encoder over ``audio_embeds`` (B, S_enc, d)
    first and holds every layer's cross (k, v). ``mesh`` (a DeviceMesh
    with a ``"model"`` axis): this rank's blocks of the cache in
    ``cache_pspecs``' layout (``distributed.sharding.CacheLayout``), the
    whole cache never built; the encoder-decoder's runs its encoder on
    the ``"model"`` ranks and computes this rank's cross blocks from it
    (``encdec.init_cache_encdec``)."""
    if is_encdec(cfg):
        return encdec.init_cache_encdec(params, cfg, audio_embeds, max_seq,
                                        dtype, mesh=mesh)
    if mesh is not None:
        from repro_torch.distributed.sharding import CacheLayout
        return CacheLayout(cfg, cache_specs(
            cfg, batch, max_seq, dtype, ring=ring, long_mode=long_mode,
            quant=quant), mesh).init(params["embed"]["embedding"].device)
    gw = LONG_GLOBAL_WINDOW if long_mode else None
    return transformer.init_cache_lm(
        cfg, batch, max_seq, dtype, ring=ring, global_window=gw, quant=quant,
        device=params["embed"]["embedding"].device)


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, enc_batch: Optional[int] = None, *,
                ring: bool = False, long_mode: bool = False,
                quant: bool = False) -> PyTree:
    """A decode cache's tree on the ``meta`` device: shapes and dtypes,
    nothing allocated (the reference's ``cache_specs``); the
    encoder-decoder's holds its cross (k, v) over the encoder sequence."""
    if is_encdec(cfg):
        return encdec.cache_shapes(cfg, batch, max_seq, dtype)
    gw = LONG_GLOBAL_WINDOW if long_mode else None
    return transformer.init_cache_lm(cfg, batch, max_seq, dtype, ring=ring,
                                     global_window=gw, quant=quant,
                                     device=torch.device("meta"))


def decode_fn(cfg: ArchConfig, *, long_mode: bool = False,
              moe_path: str = "dispatch", ring: bool = False):
    gw = LONG_GLOBAL_WINDOW if long_mode else None
    if is_encdec(cfg):
        def enc_fn(params, cache, token, pos):
            return encdec.decode_step_encdec(params, cfg, cache, token, pos)
        return enc_fn

    def fn(params, cache, token, pos):
        return transformer.decode_step_lm(params, cfg, cache, token, pos,
                                          global_window=gw, moe_path=moe_path,
                                          ring=ring)
    return fn


# ---------------------------------------------------------------------------
# input specs (shape and dtype stand-ins: nothing allocated)
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, without its data."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *,
                dtype=torch.bfloat16) -> Dict[str, TensorSpec]:
    """Model inputs for one step of ``shape.kind``: train and prefill the
    full (global_batch, seq) token batch (a vlm's tokens after its patch
    prefix, plus ``patch_embeds``; the encoder-decoder's
    ``audio_embeds``); decode one token a sequence (the cache is
    ``cache_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.arch_type == "audio":
            return {"tokens": TensorSpec((B, S), i32),
                    "audio_embeds": TensorSpec(
                        (B, cfg.encoder_seq, cfg.d_model), dtype)}
        patches = cfg.num_patch_tokens if cfg.arch_type == "vlm" else 0
        specs = {"tokens": TensorSpec((B, S - patches), i32)}
        if cfg.arch_type == "vlm":
            specs["patch_embeds"] = TensorSpec(
                (B, cfg.num_patch_tokens, cfg.d_model), dtype)
        return specs
    return {"token": TensorSpec((B,), i32)}


# ---------------------------------------------------------------------------
# parameter counting (the runtime model needs |x|)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def shapes(cfg: ArchConfig, dtype=torch.float32) -> PyTree:
    """``init``'s tree on the ``meta`` device: every leaf's shape and dtype,
    nothing drawn, nothing allocated."""
    make = encdec.init_encdec if is_encdec(cfg) else transformer.init_lm
    return make(None, cfg, dtype, torch.device("meta"))


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``, counted from ``shapes``."""
    return int(sum(t.numel() for t in tree_leaves(shapes(cfg))))


def active_param_count(cfg: ArchConfig) -> int:
    """MoE: params touched per token (top-k of E experts); dense: all."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    expert_params = 3 * cfg.d_model * cfg.d_ff * E * cfg.num_layers
    return total - expert_params + expert_params * k // E
