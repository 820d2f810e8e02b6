"""Mesh-level FedAvg train steps and the serving steps
(``repro.distributed.strategies``).

The federated strategies are a thin shim over the engine's execution
backend: ``make_fed_train_step`` builds the arch's loss function and
delegates the round (K-step local SGD, aggregation, server step) to a
``core.engine.backends.MeshBackend`` round core, the code the K-bucketed
``RoundEngine`` runs. Its two geometries:

  * ``parallel`` (cross-device FL): the round's N clients spread over the
    mesh's client axes, vmapped on each rank;
  * ``sequential`` (cross-silo FL): ``G`` client groups, spread over the
    ``"pod"`` ranks, each group's clients one after another, each client's
    local batch split over the ``"data"`` ranks; the weighted sum streams
    in ``acc_dtype`` (bf16 by default, as the reference's).

``fed_batch_specs`` and ``fed_weight_specs`` give one round's input shapes
and dtypes (``TensorSpec``). Not ported: the GSPMD sharding arguments
(``act_spec``, ``client_spmd_axes``, ``param_specs``, ``attn_kv_spec``,
``moe_shards``, ``moe_spmd_axes``: sharded parameters, ROADMAP A13 (b)),
refused unless left at their defaults, and ``sharding.py``.

On one device a serving step is the model call itself.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.engine.backends.mesh import STRATEGIES, MeshBackend
from repro_torch.core.engine.server import get_server_optimizer
from repro_torch.models import encdec, registry, transformer


# ---------------------------------------------------------------------------
# federated train steps
# ---------------------------------------------------------------------------

def make_fed_train_step(cfg: ArchConfig, *, strategy: str = "parallel",
                        remat: bool = True, moe_path: str = "dispatch",
                        use_kernel: bool = False,
                        use_kernel_avg: bool = False, act_spec=None,
                        client_spmd_axes=None, param_specs=None,
                        acc_dtype: torch.dtype = torch.bfloat16,
                        attn_kv_spec=None, moe_shards: int = 1,
                        moe_spmd_axes=None, mesh=None, device=None):
    """Returns train_step(params, batches, weights, eta) -> (new_params,
    mean first-step loss).

    parallel: batches leaves (N, K, b, ...), weights (N,); sequential:
    leaves (G, N/G, K, b, ...), weights (G, N/G), G the groups. The inputs
    are the whole round's; each rank keeps its clients (and, sequential,
    its rows of each local batch). ``mesh``: a DeviceMesh (None: one
    device, ``device``); ``use_kernel_avg`` aggregates through the
    ``fedavg_reduce`` kernel (parallel) or its streamed weighted sum
    (sequential)."""
    gspmd = dict(act_spec=act_spec, client_spmd_axes=client_spmd_axes,
                 param_specs=param_specs, attn_kv_spec=attn_kv_spec,
                 moe_spmd_axes=moe_spmd_axes)
    bad = [k for k, v in gspmd.items() if v is not None]
    bad += ["moe_shards"] if moe_shards != 1 else []
    if bad:
        raise ValueError(f"{', '.join(bad)}: GSPMD sharding arguments are "
                         f"not ported yet: they come with ROADMAP A13 (b)")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; known: "
                         f"{STRATEGIES}")
    loss_fn = registry.loss_fn(cfg, remat=remat, moe_path=moe_path,
                               use_kernel=use_kernel)
    aggregator = "kernel" if use_kernel_avg else "mean"
    server = get_server_optimizer("avg")     # plain FedAvg at server_lr=1

    def step(backend, params, batches, weights, eta):
        """One round on this rank's clients and batch rows."""
        n, b = weights.shape[0], next(iter(batches.values())).shape[2]
        lo, hi = backend.rows(n)
        blo, bhi = (backend.batch_rows(b) if strategy == "sequential"
                    else (0, b))
        batches = {k: backend.to_device(v[lo:hi, :, blo:bhi])
                   for k, v in batches.items()}
        core = backend.make_round_core(loss_fn, aggregator=aggregator,
                                       server=server, server_lr=1.0)
        new_params, first_losses = core(
            backend.place_params(params), batches,
            backend.to_device(weights[lo:hi]), float(eta), ())[:2]
        return new_params, torch.mean(first_losses)

    if strategy == "parallel":
        backend = MeshBackend(mesh, strategy="parallel", device=device)
        return lambda params, batches, weights, eta: step(
            backend, params, batches, weights, eta)

    def train_step(params, batches, weights, eta):
        # the group count is the weights' leading dim
        backend = MeshBackend(mesh, strategy="sequential",
                              groups=weights.shape[0], acc_dtype=acc_dtype,
                              device=device)
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in batches.items()}
        return step(backend, params, flat, weights.reshape(-1), eta)

    return train_step


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, without its data."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def fed_batch_specs(cfg: ArchConfig, shape: ShapeConfig, *, n_clients: int,
                    k_local: int, groups: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, TensorSpec]:
    """One federated round's batches: parallel (``groups`` None) leaves
    (N, K, b, ...), sequential (``groups`` >= 1) leaves (G, N/G, K, b,
    ...). N * b == ``shape.global_batch`` (the assigned input shape is
    the total per-local-step batch across the round's clients)."""
    if shape.global_batch % n_clients:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"divide among {n_clients} clients")
    b = shape.global_batch // n_clients
    S = shape.seq_len
    if groups is not None:
        if n_clients % groups:
            raise ValueError(f"{n_clients} clients not divisible into "
                             f"{groups} groups")
        lead: Tuple[int, ...] = (groups, n_clients // groups, k_local, b)
    else:
        lead = (n_clients, k_local, b)
    i32 = torch.int32
    if cfg.arch_type == "audio":
        return {"tokens": TensorSpec(lead + (S,), i32),
                "audio_embeds": TensorSpec(
                    lead + (cfg.encoder_seq, cfg.d_model), dtype)}
    patches = cfg.num_patch_tokens if cfg.arch_type == "vlm" else 0
    specs = {"tokens": TensorSpec(lead + (S - patches,), i32)}
    if cfg.arch_type == "vlm":
        specs["patch_embeds"] = TensorSpec(
            lead + (cfg.num_patch_tokens, cfg.d_model), dtype)
    return specs


def fed_weight_specs(n_clients: int,
                     groups: Optional[int] = None) -> TensorSpec:
    """One round's client weights: (N,), or (G, N/G) for ``groups``."""
    if groups is not None:
        return TensorSpec((groups, n_clients // groups), torch.float32)
    return TensorSpec((n_clients,), torch.float32)


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------

def make_serve_step(cfg: ArchConfig, *, long_mode: bool = False,
                    moe_path: str = "dispatch", ring: bool = False):
    """One greedy-decode step: (params, cache, token, pos) -> (logits,
    cache), the cache updated in place."""
    return registry.decode_fn(cfg, long_mode=long_mode, moe_path=moe_path,
                              ring=ring)


def make_prefill_step(cfg: ArchConfig, *, long_mode: bool = False,
                      moe_path: str = "dispatch", use_kernel: bool = False):
    """Full-sequence prefill: (params, batch) -> (last-token logits (B, V),
    decode states). The readout runs on the last position only, so the
    (B, S, V) logits never exist. ``use_kernel=True`` runs every layer's
    attention through the flash kernel, on the ``dispatch`` MoE path every
    expert FFN through the grouped-matmul kernel, and every mamba layer's
    scan through the SSD kernel. A vlm's batch carries ``patch_embeds``.
    The encoder-decoder's step takes {tokens, audio_embeds} and returns
    the last-token logits alone, through no kernel, as the reference's."""
    if registry.is_encdec(cfg):
        def encdec_prefill_step(params, batch):
            logits, _ = encdec.forward_encdec(params, cfg, batch["tokens"],
                                              batch["audio_embeds"])
            return logits[:, -1]
        return encdec_prefill_step

    gw = registry.LONG_GLOBAL_WINDOW if long_mode else None

    def prefill_step(params, batch):
        feats, _, states = transformer.forward_lm(
            params, cfg, batch["tokens"], batch.get("patch_embeds"),
            global_window=gw,
            moe_path=moe_path, use_kernel=use_kernel, return_states=True,
            return_features=True)
        logits = transformer._readout(params, cfg, feats[:, -1:])
        return logits[:, 0], states

    return prefill_step
