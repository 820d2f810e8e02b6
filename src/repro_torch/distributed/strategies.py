"""The serving steps of ``repro.distributed.strategies``.

On one device a step is the model call itself. The reference's federated
train steps delegate to its MeshBackend; the port's parallel strategy is
``core.engine.backends.MeshBackend`` (``torch.distributed``), driven by
``FedAvgTrainer(backend=...)``. Not ported yet: ``make_fed_train_step``,
the sequential strategy, the mesh arguments (``act_spec``,
``attn_kv_spec``, ``moe_shards``, ``moe_spmd_axes``), the
``dispatch_sharded`` MoE path and ``sharding.py``.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import registry, transformer


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
    scan through the SSD kernel."""
    transformer.require_ported(cfg)
    gw = registry.LONG_GLOBAL_WINDOW if long_mode else None

    def prefill_step(params, batch):
        feats, _, states = transformer.forward_lm(
            params, cfg, batch["tokens"], global_window=gw,
            moe_path=moe_path, use_kernel=use_kernel, return_states=True,
            return_features=True)
        logits = transformer._readout(params, cfg, feats[:, -1:])
        return logits[:, 0], states

    return prefill_step
