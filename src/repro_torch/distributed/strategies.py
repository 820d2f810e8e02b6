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
and dtypes (``TensorSpec``). ``param_specs`` (``sharding.param_pspecs``)
shards the params on either strategy (``MeshBackend``); ``moe_shards``
runs the MoE layers' shard-local dispatch (``moe_path="dispatch_sharded"``).
On a mesh the train steps are tensor-parallel over the ``"model"`` ranks,
on both strategies: each client's local steps run each rank's share of
every layer, forward and backward (``transformer.loss_lm(tp=)``), the
gradients through the collectives, the partial ones summed and the
blocked leaves gathered back (``sharding.ModelGrads``); ``act_spec`` sets
the stream's layout, ``moe_spmd_axes`` the ranks the token groups spread
over. A spec the layout cannot place is refused by name, and
``client_spmd_axes`` must be the backend's client axes.

On one device a serving step is the model call itself. On a mesh both
serving steps are tensor-parallel over the ``"model"`` ranks, for every
arch. The prefill (``make_prefill_step(mesh=...)``,
``models/transformer.py::prefill_lm``): ``act_spec`` sets the residual
stream's layout and spreads the batch, ``attn_kv_spec`` the K/V states'
layout, ``moe_spmd_axes`` the ranks the MoE token groups spread over. The
decode step (``make_serve_step(mesh=...)``, ``transformer.decode_step_lm``)
runs each rank's share of every layer for one token over its blocks of
the cache, kept in ``sharding.cache_pspecs``' layout between steps
(``registry.init_cache(..., mesh=)``). The encoder-decoder's prefill and
decode (``models/encdec.py::prefill_encdec``, ``decode_step_encdec``) run
its encoder and decoder on the same blocks, its self and cross caches as
blocks alike; its prefill ignores the specs, as the reference's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.engine.backends.mesh import STRATEGIES, MeshBackend
from repro_torch.core.engine.server import get_server_optimizer
from repro_torch.distributed.sharding import (DecodeRank, ModelGrads,
                                              ModelRank,
                                              tensor_parallel_layout)
from repro_torch.models import encdec, registry, transformer
from repro_torch.models.registry import TensorSpec


# ---------------------------------------------------------------------------
# federated train steps
# ---------------------------------------------------------------------------

def _check_train_specs(mesh, strategy: str, act_spec, attn_kv_spec,
                       moe_spmd_axes) -> None:
    """The train step's specs on ``mesh``, refused by name where
    ``tensor_parallel_layout`` refuses them, or where ``act_spec``'s batch
    entry names other axes than those the strategy splits a client's
    batch over (none on the parallel strategy, whose clients spread over
    the client axes; ``"data"`` on the sequential)."""
    batch_axes = tensor_parallel_layout(act_spec, attn_kv_spec,
                                        moe_spmd_axes,
                                        mesh.mesh_dim_names)[1]
    allowed = ("data",) if strategy == "sequential" else ()
    if any(a not in allowed for a in batch_axes):
        raise ValueError(
            f"act_spec's batch axes {batch_axes}: the {strategy} strategy "
            f"splits a client's batch over {allowed or 'no axis'}")


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
    and the returned params are the whole round's and whole leaves, the
    same on every rank; each rank keeps its clients (and, sequential, its
    rows of each local batch) and, with ``param_specs``, its blocks of the
    params. ``mesh``: a DeviceMesh (None: one device, ``device``, where
    the specs change no value); ``use_kernel_avg`` aggregates through the
    ``fedavg_reduce`` kernel (parallel) or its streamed weighted sum
    (sequential). ``client_spmd_axes``: None or the backend's client axes.
    ``moe_shards``, ``moe_spmd_axes``: the MoE token groups of
    ``moe_path="dispatch_sharded"``.

    On a mesh whose ``"model"`` axis has more than one rank, each client's
    local steps are tensor-parallel (``sharding.ModelRank(train=True)``,
    ``transformer.loss_lm(tp=)``): each rank runs its share of every
    layer, forward and backward, on its compute blocks, the gradients
    flowing through the collectives; ``act_spec`` sets the residual
    stream's layout (``"model"`` on the sequence, on d, or on neither),
    its batch entry the axes the strategy already splits a client's batch
    over; ``attn_kv_spec`` sets no value (no K/V state is kept);
    ``moe_spmd_axes`` ``("model",)`` spreads the token groups over the
    ranks. Partial gradients are summed over ``"model"`` every local step
    and each client's blocked leaves gathered from their owners after its
    K steps (``sharding.ModelGrads``), so every rank ends each step with
    the same params. A world of one rank is the step on one device. The
    encoder-decoder ignores the specs and computes whole, as the
    reference's loss."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; known: "
                         f"{STRATEGIES}")
    if mesh is not None and not registry.is_encdec(cfg):
        _check_train_specs(mesh, strategy, act_spec, attn_kv_spec,
                           moe_spmd_axes)
    aggregator = "kernel" if use_kernel_avg else "mean"
    server = get_server_optimizer("avg")     # plain FedAvg at server_lr=1
    loss_kw = dict(remat=remat, moe_path=moe_path, use_kernel=use_kernel,
                   moe_shards=moe_shards, moe_spmd_axes=moe_spmd_axes)
    # built at the first call: the rank's place reads the process groups,
    # its gradients' classes the params' leaves
    built = {}

    def model_rank(params):
        if not built:
            tp = None
            if mesh is not None and not registry.is_encdec(cfg):
                tp = ModelRank(mesh, act_spec, attn_kv_spec, moe_spmd_axes,
                               train=True)
                if tp.size == 1:
                    tp = None
            built["loss"] = registry.loss_fn(cfg, tp=tp, **loss_kw)
            built["grads"] = None if tp is None else ModelGrads(
                cfg, tp, params,
                transformer.moe_spreads(tp, moe_path, moe_shards))
        return built["loss"], built["grads"]

    def step(backend, params, batches, weights, eta):
        """One round on this rank's clients and batch rows."""
        n, b = weights.shape[0], next(iter(batches.values())).shape[2]
        lo, hi = backend.rows(n)
        blo, bhi = (backend.batch_rows(b) if strategy == "sequential"
                    else (0, b))
        batches = {k: backend.to_device(v[lo:hi, :, blo:bhi])
                   for k, v in batches.items()}
        loss_fn, grads = model_rank(params)
        core = backend.make_round_core(loss_fn, aggregator=aggregator,
                                       server=server, server_lr=1.0,
                                       model_grads=grads)
        new_params, first_losses = core(
            backend.place_params(params), batches,
            backend.to_device(weights[lo:hi]), float(eta), ())[:2]
        return backend.gather_state(new_params), torch.mean(first_losses)

    def check_axes(backend):
        if client_spmd_axes is not None and \
                tuple(client_spmd_axes) != backend.client_axes:
            raise ValueError(
                f"client_spmd_axes {tuple(client_spmd_axes)}: the clients "
                f"spread over the backend's client axes "
                f"{backend.client_axes}")
        return backend

    if strategy == "parallel":
        backend = check_axes(MeshBackend(mesh, strategy="parallel",
                                         param_specs=param_specs,
                                         device=device))
        return lambda params, batches, weights, eta: step(
            backend, params, batches, weights, eta)

    def train_step(params, batches, weights, eta):
        # the group count is the weights' leading dim
        backend = check_axes(MeshBackend(
            mesh, strategy="sequential", groups=weights.shape[0],
            acc_dtype=acc_dtype, param_specs=param_specs, device=device))
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in batches.items()}
        return step(backend, params, flat, weights.reshape(-1), eta)

    return train_step


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
                    moe_path: str = "dispatch", ring: bool = False,
                    mesh=None):
    """One greedy-decode step: (params, cache, token, pos) -> (logits,
    cache), the cache updated in place.

    ``mesh`` None: one device. ``mesh`` a DeviceMesh with a ``"model"``
    axis of any size: each rank computes its share of every layer for the
    token (``transformer.decode_step_lm``, ``encdec.decode_step_encdec``):
    its query heads and the kv heads they read, its d_ff block and every
    expert's, its SSM heads, its vocabulary block. ``cache`` is this
    rank's blocks in ``cache_pspecs``' layout (``registry.init_cache(...,
    mesh=mesh)``; the encoder-decoder's cross blocks too, read and never
    written), kept so between steps and written in place; the whole cache
    is never held. The step takes whole params, the whole token batch
    (B,) and a Python-int ``pos`` on every rank; the batch rows spread
    over the serve batch axes where B divides them
    (``serve_input_pspecs``), else every batch rank decodes all of them.
    Logits (B, V) come back whole on every rank, gathered once at the
    readout. It runs without autograd. A mesh without ``"model"`` and a
    cache not laid out on the step's mesh are refused by name, for every
    arch."""
    if mesh is None:
        return registry.decode_fn(cfg, long_mode=long_mode,
                                  moe_path=moe_path, ring=ring)
    if "model" not in tuple(mesh.mesh_dim_names):
        raise ValueError(f"make_serve_step: the mesh's axes "
                         f"{tuple(mesh.mesh_dim_names)} have no 'model' "
                         f"axis for the tensor-parallel decode")
    gw = registry.LONG_GLOBAL_WINDOW if long_mode else None
    ranks: Dict[int, DecodeRank] = {}

    def serve_step(params, cache, token, pos):
        layout = getattr(cache, "layout", None)
        if layout is None or layout.mesh is not mesh:
            raise ValueError(
                "make_serve_step(mesh=): the cache must be this rank's "
                "blocks on the step's mesh, from registry.init_cache(..., "
                "mesh=mesh) or make_prefill_step(..., cache_blocks=True)")
        B = int(token.shape[0])
        if layout.batch != B:
            raise ValueError(f"make_serve_step(mesh=): a batch of {B} "
                             f"tokens, the cache's of {layout.batch}")
        if B not in ranks:
            ranks[B] = DecodeRank(mesh, B)
        with torch.no_grad():
            if registry.is_encdec(cfg):
                return encdec.decode_step_encdec(params, cfg, cache, token,
                                                 int(pos), tp=ranks[B])
            return transformer.decode_step_lm(
                params, cfg, cache, token, int(pos), global_window=gw,
                moe_path=moe_path, ring=ring, tp=ranks[B])

    return serve_step


def make_prefill_step(cfg: ArchConfig, *, long_mode: bool = False,
                      moe_path: str = "dispatch", use_kernel: bool = False,
                      act_spec=None, attn_kv_spec=None, moe_shards: int = 1,
                      moe_spmd_axes=None, mesh=None,
                      cache_blocks: bool = False):
    """Full-sequence prefill: (params, batch) -> (last-token logits (B, V),
    decode states). The readout runs on the last position only, so the
    (B, S, V) logits never exist. ``use_kernel=True`` runs every layer's
    attention through the flash kernel, on the ``dispatch`` MoE path every
    expert FFN through the grouped-matmul kernel, and every mamba layer's
    scan through the SSD kernel. A vlm's batch carries ``patch_embeds``.
    ``moe_shards``: the token groups of ``moe_path="dispatch_sharded"``.

    ``mesh`` None: one device; the specs change no value, and every
    token group runs here (one ``moe_gmm`` call a layer serves them all).
    ``mesh`` a DeviceMesh with a ``"model"`` axis of any size: each rank
    computes its share of every layer (``transformer.prefill_lm``).
    ``act_spec`` (batch, seq, d): ``"model"`` on seq or on d, or on
    neither, sets the residual stream's layout; its batch entry spreads
    the batch rows over those axes (``row_range``). ``attn_kv_spec``
    (batch, key seq, kv heads, head dim): ``"model"`` on the key sequence
    keeps each layer's K/V states by sequence block until the final
    gather. ``moe_spmd_axes`` ``("model",)``: the token groups spread over
    the ``"model"`` ranks in contiguous runs. The step takes whole params
    and the whole batch on every rank and returns whole logits and
    states on every rank, gathered once at the end; it runs without
    autograd. A spec that names an axis the mesh lacks, or ``"model"``
    twice, is refused by name.

    The encoder-decoder's step takes {tokens, audio_embeds} and returns
    the last-token logits (B, V) alone, through no kernel, and ignores
    the specs and the MoE arguments, as the reference's. On a mesh each
    rank runs the encoder and the decoder on its heads, d_ff and
    vocabulary blocks (``encdec.prefill_encdec``), the stream whole on
    every ``"model"`` rank, its batch rows as the decode step's
    (``serve_input_pspecs``)."""
    if registry.is_encdec(cfg):
        ranks: Dict[int, DecodeRank] = {}

        def encdec_prefill_step(params, batch):
            B = int(batch["tokens"].shape[0])
            if B not in ranks:
                ranks[B] = DecodeRank(mesh, B)
            with torch.set_grad_enabled(torch.is_grad_enabled() and
                                        mesh is None):
                return encdec.prefill_encdec(params, cfg, batch["tokens"],
                                             batch["audio_embeds"], ranks[B])
        return encdec_prefill_step

    gw = registry.LONG_GLOBAL_WINDOW if long_mode else None
    tp = ModelRank(mesh, act_spec, attn_kv_spec, moe_spmd_axes)

    def prefill_step(params, batch):
        # the collectives on a mesh carry no gradient
        with torch.set_grad_enabled(torch.is_grad_enabled() and
                                    mesh is None):
            logits, _, states = transformer.prefill_lm(
                params, cfg, batch["tokens"], batch.get("patch_embeds"), tp,
                global_window=gw, moe_path=moe_path, use_kernel=use_kernel,
                moe_shards=moe_shards, moe_spmd_axes=moe_spmd_axes,
                cache_blocks=cache_blocks)
        return logits, states

    return prefill_step
