"""Mixture-of-Experts layer: top-k router and expert FFN bank
(``repro.models.moe``).

Three execution paths, as the reference's:

* ``dense``    — every expert computes every token, combined by the routing
  weights. Exact and simple; the serving loop decodes through it.
* ``dispatch`` — capacity-based sorted dispatch: tokens sorted by expert id
  into fixed-capacity slots, the grouped expert FFN, a weighted combine.
  ``use_kernel=True`` runs the FFN through ``kernels.ops.moe_gmm`` (three
  launches of the CUDA grouped matmul on the card).
* ``dispatch_sharded`` — shard-local dispatch: the tokens split along the
  sequence into ``shards`` groups, each routed with its own capacity and
  its own drops (``moe_apply_dispatch_sharded``). The groups' slot blocks
  stack along the capacity axis, so one ``moe_gmm`` call (three launches)
  serves every group of a rank; the tensor-parallel prefill spreads the
  groups over the ``"model"`` ranks (``moe_dispatch_groups``).

Aux load-balance loss follows Switch/Mixtral: E * sum_e f_e * P_e.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers

PATHS = ("dense", "dispatch", "dispatch_sharded")


def moe_init(gen, cfg: ArchConfig, dtype=torch.float32, device="cpu"):
    """Router and the gate/up/down banks: normal with stddev d^-0.5 (down
    f^-0.5), drawn in the reference's order."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.num_experts
    scale = 1.0 / math.sqrt(d)
    return {
        "router": {"kernel": layers.normal_init(gen, (d, E), scale, dtype,
                                                device)},
        "gate": layers.normal_init(gen, (E, d, f), scale, dtype, device),
        "up": layers.normal_init(gen, (E, d, f), scale, dtype, device),
        "down": layers.normal_init(gen, (E, f, d), 1.0 / math.sqrt(f), dtype,
                                   device),
    }


def _one_hot(ids, E: int) -> torch.Tensor:
    """f32 one-hot rows of ``ids`` (T,) over ``E`` classes, as a comparison
    against ``arange(E)``: ``F.one_hot`` reads its class count off the data
    (``.item()``), which ``torch.func.vmap`` refuses."""
    return (ids[:, None] == torch.arange(E, device=ids.device)).to(
        torch.float32)


def _route(p, cfg: ArchConfig, xf):
    """xf: (T, d) -> (weights (T, k) in xf's dtype, ids (T, k), aux)."""
    m = cfg.moe
    logits = (xf @ p["router"]["kernel"]).to(torch.float32)     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, m.top_k, dim=-1)                 # (T, k)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # load-balance aux: E * sum_e (fraction routed to e) * (mean prob of e)
    E = m.num_experts
    f_e = torch.mean(_one_hot(ids[:, 0], E), dim=0)
    P_e = torch.mean(probs, dim=0)
    aux = E * torch.sum(f_e * P_e)
    return w.to(xf.dtype), ids, aux


def _expert_ffn(p, cfg: ArchConfig, xe, ff=None):
    """xe: (E, C, d) -> (E, C, d) through each expert's gated FFN, in xe's
    dtype. ``ff`` (lo, hi): on every expert's d_ff block [lo, hi) only
    (gate and up columns, down rows), the rank's partial sum in the
    tensor-parallel decode, which the caller reduces over the ranks."""
    up = layers.block(p["up"], 2, ff)
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.einsum("ecd,edf->ecf", xe,
                                layers.block(p["gate"], 2, ff)))
        h = h * torch.einsum("ecd,edf->ecf", xe, up)
    else:  # gelu fallback
        h = F.gelu(torch.einsum("ecd,edf->ecf", xe, up), approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, layers.block(p["down"], 1, ff))


def moe_apply_dense(p, cfg: ArchConfig, x, ff=None) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """All experts on all tokens. x: (B, S, d) -> (y, aux); ``ff``: the
    experts' d_ff block (``_expert_ffn``)."""
    B, S, d = x.shape
    m = cfg.moe
    xf = x.reshape(-1, d)
    w, ids, aux = _route(p, cfg, xf)
    outs = _expert_ffn(p, cfg, xf.expand((m.num_experts,) + xf.shape), ff)
    # outs: (E, T, d); combine weighted by routing
    comb = torch.zeros((xf.shape[0], m.num_experts), dtype=x.dtype,
                       device=x.device).scatter_add(1, ids, w)
    y = torch.einsum("te,etd->td", comb, outs)
    return y.reshape(B, S, d), aux


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert: ceil(T k / E * capacity_factor) in Python floats,
    rounded up to a multiple of 8, at least 8 (the reference's)."""
    m = cfg.moe
    cap = int(math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_apply_dispatch(p, cfg: ArchConfig, x, *, use_kernel: bool = False,
                       ff=None):
    """Capacity-based sorted dispatch. x: (B, S, d) -> (y, aux); ``ff``:
    the experts' d_ff block (``_expert_ffn``; the plain FFN only)."""
    if use_kernel and ff is not None:
        raise ValueError("moe_apply_dispatch: a d_ff block (ff=) runs the "
                         "plain expert FFN, not the grouped-matmul kernel")
    B, S, d = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    dev = x.device
    _check_top_k(cfg, dev)
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    w, ids, aux = _route(p, cfg, xf)
    cap = capacity(cfg, T)

    flat_ids = ids.reshape(-1)                                  # (T*k,)
    flat_src = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = w.reshape(-1)

    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    # rank within expert = position - start offset of that expert; the
    # counts as a sum over tokens, which vmap batches (bincount it loops)
    counts = torch.sum(sorted_ids[:, None] == torch.arange(E, device=dev),
                       dim=0)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=dev) - starts[sorted_ids]
    keep = rank < cap
    slot = torch.where(keep, sorted_ids * cap + rank,
                       torch.full_like(rank, E * cap))
    src = flat_src[order]

    # dispatch: kept slots are unique, so each gets one exact add; dropped
    # tokens all land on the extra row E*cap, which is discarded
    disp = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=dev)
    disp = disp.index_add(0, slot, xf[src])
    xe = disp[:-1].reshape(E, cap, d)

    if use_kernel:
        ye = kops.moe_gmm(xe, p["gate"], p["up"], p["down"],
                          mlp_type=cfg.mlp_type)
    else:
        ye = _expert_ffn(p, cfg, xe, ff)

    yf = torch.cat([ye.reshape(E * cap, d),
                    torch.zeros((1, d), dtype=x.dtype, device=dev)])
    contrib = yf[slot] * (flat_w[order] * keep)[:, None]       # (T*k, d)
    y = torch.zeros((T, d), dtype=x.dtype, device=dev).index_add(
        0, src, contrib)
    return y.reshape(B, S, d), aux


def _check_top_k(cfg: ArchConfig, dev) -> None:
    # the combine gives each token exactly k adds onto zero; for k <= 2 the
    # sum 0 + a + b equals 0 + b + a, so the card's unordered index_add
    # repeats bit for bit
    if dev.type == "cuda" and cfg.moe.top_k > 2:
        raise ValueError(f"the dispatch combine repeats bit for bit on the "
                         f"card for top_k <= 2, not {cfg.moe.top_k}")


def moe_apply_dispatch_sharded(p, cfg: ArchConfig, x, *, shards: int,
                               spmd_axes=None, use_kernel: bool = False,
                               stacked: bool = True):
    """Shard-local dispatch (``repro/models/moe.py:125-142``). x: (B, S, d)
    -> (y, aux). The tokens split along the sequence into ``shards``
    groups of B x S/shards tokens (b-major within a group); each group
    routes and fills ``capacity(cfg, B S / shards)`` slots an expert and
    drops its own overflow; aux is the mean of the groups' aux losses.

    ``stacked`` (the default) runs the groups as one batched dispatch
    (``moe_dispatch_groups``: one expert FFN, three ``moe_gmm`` launches,
    serves them all). ``stacked=False`` loops ``moe_apply_dispatch`` over
    the groups (three launches a group). On one device every group runs
    here, whatever ``spmd_axes`` (the mesh axes the groups spread over,
    the reference's vmap binding) names; the tensor-parallel prefill
    (``make_prefill_step(mesh=...)``) spreads them over the ``"model"``
    ranks it names, each rank calling ``moe_dispatch_groups`` on its own
    contiguous run of groups."""
    B, S, d = x.shape
    if S % shards:
        raise ValueError(f"sequence {S} does not divide into {shards} "
                         f"token groups")
    if not stacked:
        S_l = S // shards
        ys, auxs = [], []
        for g in range(shards):
            y, aux = moe_apply_dispatch(p, cfg, x[:, g * S_l:(g + 1) * S_l],
                                        use_kernel=use_kernel)
            ys.append(y)
            auxs.append(aux)
        return torch.cat(ys, dim=1), torch.mean(torch.stack(auxs))
    y, aux = moe_dispatch_groups(p, cfg, x, shards, use_kernel=use_kernel)
    return y, torch.mean(aux)


def moe_dispatch_groups(p, cfg: ArchConfig, x, groups: int, *,
                        use_kernel: bool = False):
    """``groups`` token groups side by side along the sequence of x (B,
    S, d), S a multiple of ``groups``, as one batched dispatch: the
    groups' (E, C_l, d) slot blocks sit side by side along the capacity
    axis, (E, groups C_l, d), and one expert FFN serves them all. Returns
    (y (B, S, d), each group's aux loss (groups,))."""
    B, S, d = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    dev = x.device
    if groups == 0:
        return x, torch.zeros((0,), dtype=torch.float32, device=dev)
    _check_top_k(cfg, dev)
    G, S_l = groups, S // groups
    T = B * S_l                                   # tokens a group
    xg = x.reshape(B, G, S_l, d).transpose(0, 1).reshape(G * T, d)
    # a token's routing does not depend on its group: one call for every
    # token; the aux loss is each group's
    w, ids, _ = _route(p, cfg, xg)
    w, ids = w.reshape(G, T, k), ids.reshape(G, T, k)
    probs = torch.softmax((xg @ p["router"]["kernel"]).to(torch.float32),
                          dim=-1).reshape(G, T, E)
    eidx = torch.arange(E, device=dev)
    f_e = torch.mean((ids[..., 0, None] == eidx).to(torch.float32), dim=1)
    P_e = torch.mean(probs, dim=1)
    aux = E * torch.sum(f_e * P_e, dim=-1)
    cap = capacity(cfg, T)

    flat_ids = ids.reshape(G, T * k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    counts = torch.sum(sorted_ids[..., None] == eidx, dim=1)    # (G, E)
    starts = torch.cumsum(counts, -1) - counts
    rank = torch.arange(T * k, device=dev) - torch.gather(starts, 1,
                                                          sorted_ids)
    keep = rank < cap
    gi = torch.arange(G, device=dev)[:, None]
    # group g's slots of expert e: [e G C + g C, e G C + (g + 1) C)
    slot = torch.where(keep, sorted_ids * (G * cap) + gi * cap + rank,
                       torch.full_like(rank, E * G * cap)).reshape(-1)
    src = (torch.arange(T, device=dev).repeat_interleave(k)[order]
           + gi * T).reshape(-1)

    disp = torch.zeros((E * G * cap + 1, d), dtype=x.dtype, device=dev)
    disp = disp.index_add(0, slot, xg[src])
    xe = disp[:-1].reshape(E, G * cap, d)
    if use_kernel:
        ye = kops.moe_gmm(xe, p["gate"], p["up"], p["down"],
                          mlp_type=cfg.mlp_type)
    else:
        ye = _expert_ffn(p, cfg, xe)

    yf = torch.cat([ye.reshape(E * G * cap, d),
                    torch.zeros((1, d), dtype=x.dtype, device=dev)])
    wk = (torch.gather(w.reshape(G, T * k), 1, order) * keep).reshape(-1)
    y = torch.zeros((G * T, d), dtype=x.dtype, device=dev).index_add(
        0, src, yf[slot] * wk[:, None])
    return y.reshape(G, B, S_l, d).transpose(0, 1).reshape(B, S, d), aux


def moe_apply(p, cfg: ArchConfig, x, *, path: str = "dispatch",
              use_kernel: bool = False, shards: int = 1, spmd_axes=None,
              ff=None):
    """The MoE layer on ``path``; ``ff`` (dense and dispatch): the experts'
    d_ff block of a ``"model"`` rank in the tensor-parallel decode, which
    returns the rank's partial sum (the router whole: every rank routes
    alike)."""
    if path == "dense":
        return moe_apply_dense(p, cfg, x, ff)
    if path == "dispatch_sharded" and shards > 1:
        if ff is not None:
            raise ValueError("dispatch_sharded token groups take no d_ff "
                             "block (ff=)")
        return moe_apply_dispatch_sharded(p, cfg, x, shards=shards,
                                          spmd_axes=spmd_axes,
                                          use_kernel=use_kernel)
    if path in ("dispatch", "dispatch_sharded"):
        return moe_apply_dispatch(p, cfg, x, use_kernel=use_kernel, ff=ff)
    raise ValueError(f"unknown moe path {path!r}: one of {PATHS}")
