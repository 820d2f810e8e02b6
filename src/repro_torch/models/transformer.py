"""Decoder-only LM for the dense, MoE, SSM, hybrid and vision-language
architectures (``repro.models.transformer``; the encoder-decoder family is
``models/encdec.py``).

Layers are grouped into *cycles*, one repetition of ``cfg.layer_pattern``
(e.g. (local, global) for gemma2, five mamba and a shared attention block
for zamba2). The params of all cycles are stacked on a leading axis under
``params["stack"]["b{i}"]`` with the reference's keys, so
``bridge.params_from_jax`` maps a reference tree 1:1; the reference's
``lax.scan`` over cycles is a loop over that axis, and ``remat``
recomputes one cycle at a time in the backward when autograd is on
(``layers.remat``, which runs under ``torch.func`` transforms too).

A vision-language model (``arch_type`` "vlm") takes its patch embeddings
(the stub vision frontend's output) ahead of the text tokens; the loss
skips those prefix positions. An MoE block
holds ``moe`` (``models/moe.py``) where a dense block holds ``mlp``; its
load-balance aux is summed over the layers and never kept in the decode
states. A mamba block holds ``{"ln", "ssm"}`` (``models/ssm.py``) and its
decode state is ``{"ssm", "conv"}``. A hybrid's ``attn`` positions all run
the one block in ``params["shared"]`` (absent from the stack) and each
keeps its own KV cache.

Every block runs as one ``"model"`` rank (``distributed.sharding.
ModelRank``) on its blocks (``ComputeBlocks``). A model on one device is
the one rank of every block, its collectives the identity, so its ops are
the plain ones. ``prefill_lm`` is also the tensor-parallel prefill: the
rank's batch rows, the residual stream in its layout, each block's
column- and row-parallel products on the rank's blocks of heads, d_ff and
SSM heads, its run of MoE token groups, the readout on its vocabulary
block; logits and decode states are gathered whole on every rank at the
end (or the states kept as the rank's blocks of the cache layout,
``cache_blocks``). ``decode_step_lm`` is also the tensor-parallel decode
(``distributed.sharding.DecodeRank``): the rank's batch rows, the stream
(B_r, 1, d) whole, each block on its heads, d_ff and SSM heads over its
blocks of the cache (``sharding.CacheLayout``), the logits gathered whole
from its vocabulary block. ``loss_lm(tp=)`` is the tensor-parallel loss of
the train step: ``prefill_lm``'s block path with autograd on, every
collective differentiable (``kernels.collectives``), the stream gathered
whole for the readout and cross-entropy.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.collectives import row_range
from repro_torch.models import attention, layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.optim import tree_leaves, tree_map

PyTree = Any

# ---------------------------------------------------------------------------
# structure helpers
# ---------------------------------------------------------------------------

def cycle_spec(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.layer_pattern is None:
        return ("mamba",) if cfg.arch_type == "ssm" else ("attn",)
    return tuple(cfg.layer_pattern)


def cycle_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(num full cycles, number of tail layers)."""
    n = len(cycle_spec(cfg))
    return cfg.num_layers // n, cfg.num_layers % n


def _is_shared(cfg: ArchConfig, ltype: str) -> bool:
    return cfg.arch_type == "hybrid" and ltype == "attn"


def _layer_window(cfg: ArchConfig, ltype: str,
                  global_window: Optional[int]) -> Optional[int]:
    if ltype == "local":
        return cfg.sliding_window
    if ltype == "global":
        return global_window           # None normally; capped in long mode
    # plain "attn": honour an arch-level sliding window
    if cfg.sliding_window is None:
        return global_window
    return cfg.sliding_window


def _index(tree: PyTree, i: int) -> PyTree:
    """One cycle's slice of a stacked tree (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


def _unbind(tree: PyTree) -> list:
    """Every cycle's slice of a stacked tree (views), from one
    ``torch.unbind`` a leaf: its backward stacks the cycles' gradients
    once, where ``_index`` a cycle gives each cycle a zero-filled gradient
    of the whole stack to add up (O(cycles²) traffic in training)."""
    parts = tree_map(lambda t: torch.unbind(t, 0), tree)
    return [tree_map(lambda u: u[c], parts)
            for c in range(len(tree_leaves(parts)[0]))]


def _stack(trees) -> PyTree:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _stack_init(make, n: int) -> PyTree:
    """Stack ``n`` trees from ``make()`` (called in order) on a new leading
    axis, copying each into its slot as it is made: the device holds the
    stack and one tree, never two stacks (a full-width MoE layer is GBs)."""
    out = None
    for i in range(n):
        tree = make()
        if out is None:
            out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)),
                           tree)
        tree_map(lambda dst, src: dst.copy_(src), _index(out, i), tree)
        del tree                 # freed before the next is drawn
    return out


# ---------------------------------------------------------------------------
# single block init/apply
# ---------------------------------------------------------------------------

def _block_init(gen, cfg: ArchConfig, ltype: str, dtype, device):
    if ltype == "mamba":
        return {"ln": layers.norm_init(cfg.norm_type, cfg.d_model, dtype,
                                       device),
                "ssm": ssm_lib.ssm_init(gen, cfg, dtype, device)}
    p = {"ln1": layers.norm_init(cfg.norm_type, cfg.d_model, dtype, device),
         "attn": attention.attn_init(gen, cfg, dtype, device),
         "ln2": layers.norm_init(cfg.norm_type, cfg.d_model, dtype, device)}
    if cfg.moe is not None and not _is_shared(cfg, ltype):
        p["moe"] = moe_lib.moe_init(gen, cfg, dtype, device)
    else:
        d_ff = cfg.d_ff if cfg.d_ff else 4 * cfg.d_model
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, d_ff, cfg.mlp_type,
                                   dtype, device)
    return p


def _normed(tp, b, kind, p, x, partial: bool = True):
    """A block's normed input, whole (B_r, S, d), from the stream ``x`` in
    its layout: the norm on the rank's rows, then the all-gather; with d
    sharded, the all-gather first. ``partial``: its readers are the
    rank's column blocks or token groups (``ModelRank.gather_stream``),
    not a computation every rank runs alike."""
    if tp.layout == "d":
        return layers.norm_apply(kind, p, tp.gather_stream(x, b, partial))
    return tp.gather_stream(layers.norm_apply(kind, p, x), b, partial)


def moe_spreads(tp, moe_path: str, shards: int) -> bool:
    """Whether the MoE token groups spread over the ``"model"`` ranks."""
    return moe_path == "dispatch_sharded" and shards > 1 and \
        tp.moe_size > 1


def _moe_groups(tp, seq_len: int, moe_path: str, shards: int):
    """(this rank's token range [t0, t1), every rank's token counts or
    None, whether the groups spread over the ranks): a spread rank holds
    a contiguous run of the ``shards`` groups (``row_range``); unspread,
    every rank runs every token."""
    if not moe_spreads(tp, moe_path, shards):
        return (0, seq_len), None, False
    if seq_len % shards:
        raise ValueError(f"sequence {seq_len} does not divide into "
                         f"{shards} token groups")
    S_l = seq_len // shards
    runs = [row_range(shards, tp.moe_size, j) for j in range(tp.moe_size)]
    g0, g1 = runs[tp.rank]
    return (g0 * S_l, g1 * S_l), [(hi - lo) * S_l for lo, hi in runs], True


def _moe_sublayer(bp, cfg: ArchConfig, x, tp, b, *, moe_path, use_kernel,
                  shards, spmd_axes, n_batch):
    """The MoE sublayer of one rank: its token groups over the whole batch
    (the groups of ``moe_apply_dispatch_sharded``), routed and dispatched
    here through one stacked expert FFN, the outputs put back into the
    stream's layout. Returns (h in the layout, aux: the layer's whole aux,
    or where the groups spread, this rank's share of it). Where the
    stream is split by sequence blocks that are this rank's groups, no
    token moves."""
    S = sum(b.seq_sizes)
    (t0, t1), sizes, spread = _moe_groups(tp, S, moe_path, shards)
    kind = cfg.norm_type
    split_batch = tp.batch_count > 1
    in_place = spread and tp.layout == "seq" and not split_batch and \
        all(n == m for n, m in zip(sizes, b.seq_sizes))
    if in_place:
        xin = layers.norm_apply(kind, bp["ln2"], x)
    else:
        hn = _normed(tp, b, kind, bp["ln2"], x, partial=spread)
        if split_batch:
            hn = tp.gather_batch(hn, 0, n_batch)
        xin = layers.block(hn, 1, (t0, t1))
    if spread:
        y, aux = moe_lib.moe_dispatch_groups(
            bp["moe"], cfg, xin, (t1 - t0) * shards // S,
            use_kernel=use_kernel)
        aux = torch.sum(aux) / shards
    else:
        y, aux = moe_lib.moe_apply(bp["moe"], cfg, xin, path=moe_path,
                                   use_kernel=use_kernel, shards=shards,
                                   spmd_axes=spmd_axes)
    if in_place:
        return y, aux
    if spread:
        y = tp.gather(y, 1, sizes)
    if split_batch:
        y = layers.block(y, 0, tp.batch_rows(n_batch))
    return tp.stream_block(y, b), aux


def _block_apply(bp, cfg: ArchConfig, ltype: str, x, positions, *, tp, b,
                 global_window=None, moe_path="dispatch", use_kernel=False,
                 moe_shards=1, moe_spmd_axes=None, n_batch=1):
    """Full-sequence block of the ``"model"`` rank ``tp`` on its blocks
    ``b``: x and the returned x in the stream's layout, each row-parallel
    partial reduced back into it. Returns (x, decode state + {aux}): the
    caller pops the MoE aux out of the decode state."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if ltype == "mamba":
        h, state = ssm_lib.ssm_forward(
            bp["ssm"], cfg, _normed(tp, b, cfg.norm_type, bp["ln"], x),
            use_kernel=use_kernel, heads=b.ssm, all_reduce=tp.norm_reduce)
        state["aux"] = zero
        return x + tp.reduce_partial(h, b), state
    h, (k, v) = attention.attention(
        bp["attn"], cfg, _normed(tp, b, cfg.norm_type, bp["ln1"], x),
        positions, window=_layer_window(cfg, ltype, global_window),
        use_kernel=use_kernel, heads=b.heads,
        kv_rows=b.seq if tp.kv_seq else None)
    x = x + tp.reduce_partial(h, b)
    if "moe" in bp:
        h, aux = _moe_sublayer(bp, cfg, x, tp, b, moe_path=moe_path,
                               use_kernel=use_kernel, shards=moe_shards,
                               spmd_axes=moe_spmd_axes, n_batch=n_batch)
    else:
        h = tp.reduce_partial(layers.mlp_apply(
            bp["mlp"], _normed(tp, b, cfg.norm_type, bp["ln2"], x),
            cfg.mlp_type, ff=b.ff), b)
        aux = zero
    return x + h, {"k": k, "v": v, "aux": aux}


def _conv_window(tp, cfg: ArchConfig, b, conv, spec):
    """The conv window of the rank's channels (its x channels, then B and
    C) from its rest block ``conv``, which is cut evenly over conv_dim
    (``spec``'s channel entry ``"model"``) or whole: (a function of the
    rank's raw new row that returns its window (B, d_conv, channels), for
    ``ssm_decode_step``; a list that then holds the next whole window (B,
    d_conv - 1, conv_dim)). One all-gather a step puts every rank's rest
    block and its new row's x channels together; B and C are every
    rank's."""
    nxt = []
    if tp.size == 1:
        def window(row):
            w = torch.cat([conv, row], dim=1)
            nxt.append(w[:, 1:])
            return w
        return window, nxt
    P = cfg.ssm.head_dim
    cut = spec[-1] == "model"

    def window(row):
        B, t, c = conv.shape
        xr = (b.ssm[1] - b.ssm[0]) * P
        mine = row[:, 0, :xr]
        if cut:
            mine = torch.cat([conv.reshape(B, t * c), mine], dim=1)
        parts = tp.gather(mine, 1, [(t * c if cut else 0) + n * P
                                    for n in b.ssm_sizes])
        olds, xs, off = [], [], 0
        for n in b.ssm_sizes:
            if cut:
                olds.append(parts[:, off:off + t * c].reshape(B, t, c))
                off += t * c
            xs.append(parts[:, off:off + n * P])
            off += n * P
        old = torch.cat(olds, dim=-1) if cut else conv
        new = torch.cat([torch.cat(xs, dim=1)[:, None], row[..., xr:]],
                        dim=-1)
        w = torch.cat([old, new], dim=1)
        nxt.append(w[:, 1:])
        return ssm_lib._channels(cfg, w, *b.ssm)
    return window, nxt


def _block_decode(bp, cfg: ArchConfig, ltype: str, x, state, pos, *, tp, b,
                  rest=None, global_window=None, moe_path="dense",
                  ring=False, n_batch=1):
    """One token through one block on the ``"model"`` rank ``tp`` and its
    blocks ``b``: x (B_r, 1, d) whole, each row-parallel partial
    all-reduced over the ranks. Writes its slot of ``state``, this rank's
    cache blocks (a mamba block: its SSM and conv states), in place.
    ``rest``: the block's cache specs and whole shapes ((specs, shapes),
    each {leaf: ...}), None on one device (every block whole)."""
    if ltype == "mamba":
        spec = rest[0] if rest is not None else {"ssm": (None,) * 4,
                                                 "conv": (None,) * 3}
        window, nxt = _conv_window(tp, cfg, b, state["conv"], spec["conv"])
        ssm_rest = tp.size == 1 or spec["ssm"][-3] == "model"
        st = state["ssm"] if ssm_rest else layers.block(state["ssm"], 1,
                                                        b.ssm)
        h, new = ssm_lib.ssm_decode_step(
            bp["ssm"], cfg, layers.norm_apply(cfg.norm_type, bp["ln"], x),
            {"ssm": st}, heads=b.ssm, all_reduce=tp.norm_reduce,
            conv_window=window)
        state["ssm"].copy_(new["ssm"] if ssm_rest else
                           tp.gather(new["ssm"], 1, b.ssm_sizes))
        conv = state["conv"]
        conv.copy_(nxt[0] if tp.size == 1 or spec["conv"][-1] != "model"
                   else nxt[0][..., tp.rank * conv.shape[-1]:
                               (tp.rank + 1) * conv.shape[-1]])
        return x + tp.all_reduce(h), state
    window = _layer_window(cfg, ltype, global_window)
    use_ring = ring and window is not None
    place = (attention.KVPlace(state["k"].shape[1]) if rest is None else
             tp.kv_place(rest[0]["k"], rest[1]["k"].shape, b))
    xn = layers.norm_apply(cfg.norm_type, bp["ln1"], x)
    kw = dict(window=window, ring=use_ring, heads=b.heads, place=place)
    if "ks" in state:        # two-level int8 cache (Q-KV)
        h, state = attention.attention_decode_quant(bp["attn"], cfg, xn,
                                                    state, pos, **kw)
    else:
        h, _, _ = attention.attention_decode(
            bp["attn"], cfg, xn, state["k"], state["v"], pos, **kw)
    x = x + tp.all_reduce(h)
    hn = layers.norm_apply(cfg.norm_type, bp["ln2"], x)
    if "moe" in bp:
        # dispatch routes the whole batch, as one device does: its
        # capacity and drops are the whole batch's
        whole = tp.batch_count > 1 and moe_path != "dense"
        h, _ = moe_lib.moe_apply(
            bp["moe"], cfg, tp.gather_batch(hn, 0, n_batch) if whole
            else hn, path=moe_path, ff=b.ff)
        if whole:
            h = layers.block(h, 0, tp.batch_rows(n_batch))
    else:
        h = layers.mlp_apply(bp["mlp"], hn, cfg.mlp_type, ff=b.ff)
    return x + tp.all_reduce(h), state


# ---------------------------------------------------------------------------
# model init
# ---------------------------------------------------------------------------

def init_lm(gen: Optional[torch.Generator], cfg: ArchConfig,
            dtype=torch.float32, device="cpu") -> PyTree:
    """The reference's parameter tree, drawn from ``gen`` (on the ``meta``
    device: shapes only, ``gen`` unused)."""
    spec = cycle_spec(cfg)
    n_cycles, n_tail = cycle_counts(cfg)
    params: Dict[str, Any] = {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, device),
        "final_norm": layers.norm_init(cfg.norm_type, cfg.d_model, dtype,
                                       device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, cfg.d_model,
                                              cfg.vocab_size, dtype=dtype,
                                              device=device)
    if cfg.arch_type == "hybrid":
        params["shared"] = _block_init(gen, cfg, "shared_attn_block", dtype,
                                       device)
    if n_cycles > 0:
        params["stack"] = _stack_init(
            lambda: {f"b{i}": _block_init(gen, cfg, lt, dtype, device)
                     for i, lt in enumerate(spec)
                     if not _is_shared(cfg, lt)}, n_cycles)
    if n_tail:
        params["tail"] = {f"b{i}": _block_init(gen, cfg, spec[i], dtype,
                                               device)
                          for i in range(n_tail)
                          if not _is_shared(cfg, spec[i])}
    return params


def _block_params(cfg: ArchConfig, ltype: str, blocks, i: int, shared):
    """The params of block ``i`` of a cycle (or the tail): the shared
    attention block at a hybrid's ``attn`` positions."""
    return shared if _is_shared(cfg, ltype) else blocks[f"b{i}"]


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _cycle_apply(cparams, shared, cfg, x, positions, kw):
    """One cycle -> (x, {b{i}: decode state}, the cycle's summed aux)."""
    states = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lt in enumerate(cycle_spec(cfg)):
        x, st = _block_apply(_block_params(cfg, lt, cparams, i, shared), cfg,
                             lt, x, positions, **kw)
        aux = aux + st.pop("aux")
        states[f"b{i}"] = st
    return x, states, aux


def embed_inputs(params, cfg: ArchConfig, tokens, patch_embeds=None):
    """Token (+ a vlm's patch) embedding. Returns (x, positions,
    n_prefix)."""
    x = layers.embedding_apply(params["embed"], tokens)
    n_prefix = 0
    if cfg.arch_type == "vlm" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
        n_prefix = patch_embeds.shape[1]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    return x, positions, n_prefix


def _one_device():
    """The ``ModelRank`` of a model on one device (imported here: the
    ``distributed`` package imports this module)."""
    from repro_torch.distributed.sharding import ModelRank
    return ModelRank(None)


def _cycle_remat(cparams, shared, cfg: ArchConfig, x, positions, kw):
    """One cycle without its decode states: (x, the cycle's aux)."""
    x, _, aux = _cycle_apply(cparams, shared, cfg, x, positions, kw)
    return x, aux


def _run_layers(params, cfg: ArchConfig, x, positions, kw, *, remat=False,
            return_states=False):
    """Every cycle, then the tail, from the stream ``x``: (x, the MoE aux
    summed over the layers, decode states stacked over cycles or None).
    ``remat`` (with autograd on; no states) recomputes each cycle in the
    backward (``layers.remat``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared")
    stack_states = None
    if "stack" in params:
        per_cycle, auxs = [], []
        for cparams in _unbind(params["stack"]):
            if remat and torch.is_grad_enabled() and not return_states:
                x, a = layers.remat(_cycle_remat, cparams, shared, cfg, x,
                                    positions, kw)
                st = None
            else:
                x, st, a = _cycle_apply(cparams, shared, cfg, x, positions,
                                        kw)
            auxs.append(a)
            if return_states:
                per_cycle.append(st)
        aux = aux + torch.sum(torch.stack(auxs))
        if return_states:
            stack_states = _stack(per_cycle)
    tail_states = {}
    if "tail" in params:
        spec = cycle_spec(cfg)
        for i in range(cfg.num_layers % len(spec)):
            x, st = _block_apply(
                _block_params(cfg, spec[i], params["tail"], i, shared), cfg,
                spec[i], x, positions, **kw)
            aux = aux + st.pop("aux")
            tail_states[f"b{i}"] = st
    return x, aux, (
        {"stack": stack_states, "tail": tail_states} if return_states
        else None)


def forward_lm(params, cfg: ArchConfig, tokens, patch_embeds=None, *,
               global_window: Optional[int] = None, remat: bool = False,
               moe_path: str = "dispatch", use_kernel: bool = False,
               return_states: bool = False, return_features: bool = False,
               moe_shards: int = 1, moe_spmd_axes=None):
    """Full-sequence forward on one device. Returns (logits|features,
    aux[, decode states]); states are stacked over cycles like the
    params, and aux is the MoE load-balance loss summed over the layers
    (0 for dense). ``patch_embeds``: a vlm's (B, P, d) patch embeddings,
    read ahead of the tokens. ``moe_shards``, ``moe_spmd_axes``: the token
    groups of ``moe_path="dispatch_sharded"`` (``models/moe.py``)."""
    x, positions, _ = embed_inputs(params, cfg, tokens, patch_embeds)
    tp = _one_device()
    kw = dict(tp=tp, b=tp.blocks(cfg, x.shape[1]),
              global_window=global_window, moe_path=moe_path,
              use_kernel=use_kernel, moe_shards=moe_shards,
              moe_spmd_axes=moe_spmd_axes, n_batch=x.shape[0])
    x, aux, states = _run_layers(params, cfg, x, positions, kw, remat=remat,
                             return_states=return_states)
    out = x if return_features else _readout(params, cfg, x)
    if return_states:
        return out, aux, states
    return out, aux


def _last_logits(params, cfg: ArchConfig, x, tp, b):
    """Last-token logits (B_r, V) from the stream in its layout: the last
    position gathered whole, the readout on the rank's vocabulary block
    (the tied embedding's rows or ``lm_head``'s columns) with the final
    softcap, then the blocks all-gathered."""
    last = x[:, -1:]
    if tp.layout == "seq":          # the last rank that holds a row has it
        last = tp.gather(last, 1, [min(n, 1) for n in b.seq_sizes])[:, -1:]
    elif tp.layout == "d":
        last = tp.gather(last, 2, b.d_sizes)
    logits = _readout(params, cfg, last, vocab=b.vocab)
    return tp.gather(logits, 2, b.vocab_sizes)[:, 0]


def _gather_states(tree, cfg: ArchConfig, tp, b, n_batch: int):
    """Whole decode states from every rank's blocks: K/V by the kv heads
    each rank owns (or, ``attn_kv_spec`` over the key sequence, by its
    sequence block), SSM states by head, conv states by the x channels of
    each rank's heads with B and C taken once; then the batch rows. One
    all-gather a leaf and axis."""
    return {k: (v if v is None else
                _gather_states(v, cfg, tp, b, n_batch) if isinstance(v, dict)
                else _gather_leaf(k, v, cfg, tp, b, n_batch))
            for k, v in tree.items()}


def _gather_leaf(key, t, cfg, tp, b, n_batch):
    nd = t.dim()
    if key in ("k", "v"):
        t = (tp.gather(t, nd - 3, b.seq_sizes) if tp.kv_seq
             else tp.gather(t, nd - 2, b.kv_sizes))
        return tp.gather_batch(t, nd - 4, n_batch)
    if key == "ssm":
        return tp.gather_batch(tp.gather(t, nd - 3, b.ssm_sizes), nd - 4,
                               n_batch)
    if tp.size > 1:                                       # "conv"
        P = cfg.ssm.head_dim
        xr = (b.ssm[1] - b.ssm[0]) * P
        t = torch.cat([tp.gather(t[..., :xr], nd - 1,
                                 [n * P for n in b.ssm_sizes]),
                       t[..., xr:]], dim=-1)
    return tp.gather_batch(t, nd - 3, n_batch)


def _held_as_block(key: str, spec, tp, n_batch: int) -> bool:
    """Whether the prefill's state leaf ``key`` on this rank is already
    its block under ``spec`` (``cache_pspecs``): the same batch rows, and
    the kv heads it owns over ``"model"`` where the kv heads are split
    there (the SSM heads alike), or one ``"model"`` rank."""
    from repro_torch.distributed.sharding import _names
    from repro_torch.kernels.collectives import axes_size

    def split(axes):
        return tuple(a for a in axes if axes_size(tp.mesh, (a,)) > 1)

    be = spec[-3] if key == "conv" else spec[-4]
    mine = split(tp.batch_axes) if tp.batch_count > 1 else ()
    if split(_names(be)) != mine or n_batch % max(tp.batch_count, 1):
        return False
    if tp.size == 1:
        return True
    if key in ("k", "v"):
        return not tp.kv_seq and spec[-2] == "model"
    return key == "ssm" and spec[-3] == "model"


def _state_blocks(states, cfg: ArchConfig, tp, b, n_batch: int, dtype):
    """The decode states as this rank's blocks in ``cache_pspecs``' layout
    of their own shapes (a ``CacheBlocks``): a leaf the rank holds as its
    block stays as it is; any other is gathered whole (``_gather_leaf``)
    and cut, one leaf at a time, so the whole states never exist
    together."""
    from repro_torch.distributed.sharding import CacheLayout
    from repro_torch.kernels.collectives import block_of
    layout = CacheLayout(cfg, init_cache_lm(cfg, n_batch, sum(b.seq_sizes),
                                            dtype, device="meta"), tp.mesh)

    def leaf(keys, spec):
        t = states
        for k in keys:
            t = t[k]
        if _held_as_block(keys[-1], spec, tp, n_batch):
            return t
        return block_of(_gather_leaf(keys[-1], t, cfg, tp, b, n_batch),
                        spec, tp.mesh)
    return layout.map(leaf)


def prefill_lm(params, cfg: ArchConfig, tokens, patch_embeds, tp, *,
               global_window: Optional[int] = None,
               moe_path: str = "dispatch", use_kernel: bool = False,
               moe_shards: int = 1, moe_spmd_axes=None,
               cache_blocks: bool = False):
    """The prefill of the ``"model"`` rank ``tp`` (``distributed.sharding.
    ModelRank``; ``ModelRank(None)``: one device). ``params``, ``tokens``
    (B, S) and ``patch_embeds`` are whole; the rank reads its batch rows
    and its blocks of each leaf. Returns (last-token logits (B, V), the MoE aux
    summed over the layers, decode states stacked over cycles as
    ``forward_lm``'s), whole and the same on every rank; ``cache_blocks``:
    the states as this rank's blocks in ``cache_pspecs``' layout of their
    own shapes instead (``_state_blocks``)."""
    n_batch = tokens.shape[0]
    rows = tp.batch_rows(n_batch)
    x, positions, _ = embed_inputs(
        params, cfg, layers.block(tokens, 0, rows),
        None if patch_embeds is None else layers.block(patch_embeds, 0,
                                                       rows))
    b = tp.blocks(cfg, x.shape[1])
    kw = dict(tp=tp, b=b, global_window=global_window, moe_path=moe_path,
              use_kernel=use_kernel, moe_shards=moe_shards,
              moe_spmd_axes=moe_spmd_axes, n_batch=n_batch)
    x, aux, states = _run_layers(params, cfg, tp.stream_block(x, b), positions,
                             kw, return_states=True)
    logits = tp.gather_batch(_last_logits(params, cfg, x, tp, b), 0, n_batch)
    if cfg.moe is not None and _moe_groups(tp, sum(b.seq_sizes), moe_path,
                                           moe_shards)[2]:
        aux = tp.all_reduce(aux)
    if cache_blocks:
        return logits, aux, _state_blocks(states, cfg, tp, b, n_batch,
                                          x.dtype)
    return logits, aux, _gather_states(states, cfg, tp, b, n_batch)

# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def xent_loss(logits, targets, mask=None):
    """Token cross-entropy in f32. logits: (B,S,V); targets: (B,S) int."""
    logits32 = logits.to(torch.float32)
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# Chunk the readout + cross-entropy over sequence positions when the full
# (B, S, V) logits would be large: each chunk's logits are recomputed in the
# backward pass, so they never all exist (the reference's constants).
LOSS_CHUNK = 512
LOSS_CHUNK_MIN_ELEMENTS = 1 << 28      # B*S*V above this triggers chunking


def _readout(params, cfg: ArchConfig, x, vocab=None):
    """Logits of the features x; ``vocab`` (lo, hi): of that vocabulary
    block only (the tied embedding's rows or ``lm_head``'s columns)."""
    x = layers.norm_apply(cfg.norm_type, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = layers.embedding_attend(params["embed"], x, rows=vocab)
    else:
        logits = layers.dense_apply(params["lm_head"], x, cols=vocab)
    return layers.softcap(logits, cfg.final_logit_softcap)


def _chunk_nll(params, cfg, f, t, m):
    """(sum of masked nll, sum of mask) over one chunk."""
    logits32 = _readout(params, cfg, f).to(torch.float32)
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, t.long()[..., None])[..., 0]
    return torch.sum((logz - gold) * m), torch.sum(m)


def _chunked_xent(params, cfg: ArchConfig, feats, targets, mask=None):
    """feats: (B, S, d) pre-readout features; targets: (B, S)."""
    B, S, _ = feats.shape
    chunk = LOSS_CHUNK
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=feats.device)
    pad = (-S) % chunk
    if pad:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    nll = torch.zeros((), dtype=torch.float32, device=feats.device)
    msum = torch.zeros((), dtype=torch.float32, device=feats.device)
    read = "embed" if cfg.tie_embeddings else "lm_head"
    head = {"final_norm": params["final_norm"], read: params[read]}
    for off in range(0, S + pad, chunk):
        args = (head, cfg, feats[:, off:off + chunk],
                targets[:, off:off + chunk], mask[:, off:off + chunk])
        n, m = (layers.remat(_chunk_nll, *args) if torch.is_grad_enabled()
                else _chunk_nll(*args))
        nll, msum = nll + n, msum + m
    return nll / torch.clamp(msum, min=1.0)


def _features_on_rank(params, cfg: ArchConfig, tokens, patch_embeds, tp, *,
                      remat: bool, moe_path: str, use_kernel: bool,
                      moe_shards: int, moe_spmd_axes):
    """The features (B, S, d) and the MoE aux of the train step's
    ``"model"`` rank ``tp`` (``ModelRank(train=True)``), whole and alike on
    every rank: ``prefill_lm``'s block path on the rank's blocks, from the
    stream's block in its layout, gathered whole after the last layer."""
    x, positions, _ = embed_inputs(params, cfg, tokens, patch_embeds)
    b = tp.blocks(cfg, x.shape[1])
    kw = dict(tp=tp, b=b, moe_path=moe_path, use_kernel=use_kernel,
              moe_shards=moe_shards, moe_spmd_axes=moe_spmd_axes,
              n_batch=x.shape[0])
    x, aux, _ = _run_layers(params, cfg, tp.stream_block(x, b), positions,
                            kw, remat=remat)
    if cfg.moe is not None and moe_spreads(tp, moe_path, moe_shards):
        aux = tp.all_reduce(aux)        # each rank's groups' share
    return tp.gather_stream(x, b, partial=False), aux


def loss_lm(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, moe_path: str = "dispatch",
            use_kernel: bool = False, moe_shards: int = 1,
            moe_spmd_axes=None, tp=None):
    """Next-token LM loss plus ``router_aux_coef`` x the MoE aux. batch:
    {tokens, [patch_embeds], [mask]}. Returns (loss, {"xent", "aux"}).

    ``tp``: the train step's ``"model"`` rank (``distributed.sharding.
    ModelRank(train=True)``; None, or one rank: one device). Its batch is
    the rank's rows; each rank runs its share of every layer, forward and
    backward, on its blocks (``_features_on_rank``), and the readout and
    cross-entropy whole, so every rank computes the same loss."""
    tokens = batch["tokens"]
    patch = batch.get("patch_embeds")
    kw = dict(remat=remat, moe_path=moe_path, use_kernel=use_kernel,
              moe_shards=moe_shards, moe_spmd_axes=moe_spmd_axes)
    if tp is None or tp.size == 1:
        feats, aux = forward_lm(params, cfg, tokens, patch,
                                return_features=True, **kw)
    else:
        feats, aux = _features_on_rank(params, cfg, tokens, patch, tp, **kw)
    n_prefix = (patch.shape[1] if patch is not None
                and cfg.arch_type == "vlm" else 0)
    # tokens[t + 1] is predicted from sequence position n_prefix + t
    pred_feats = feats[:, n_prefix:-1]
    targets = tokens[:, 1:]
    mask = batch.get("mask")
    mask = mask[:, 1:].to(torch.float32) if mask is not None else None
    B, Sm1 = targets.shape
    if B * Sm1 * cfg.vocab_size >= LOSS_CHUNK_MIN_ELEMENTS and Sm1 > LOSS_CHUNK:
        loss = _chunked_xent(params, cfg, pred_feats, targets, mask)
    else:
        loss = xent_loss(_readout(params, cfg, pred_feats), targets, mask)
    aux_coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0
    return loss + aux_coef * aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode (serve)
# ---------------------------------------------------------------------------

def _block_cache(cfg: ArchConfig, ltype: str, batch: int, max_seq: int, dtype,
                 ring: bool = False, global_window=None, quant: bool = False,
                 device="cpu"):
    if ltype == "mamba":
        return ssm_lib.ssm_init_state(cfg, batch, dtype, device)
    # ring=True: windowed layers allocate a window-length ring buffer
    eff = max_seq
    if ring:
        w = _layer_window(cfg, ltype, global_window)
        if w is not None:
            eff = min(max_seq, w)
    shape = (batch, eff, cfg.num_kv_heads, cfg.head_dim)
    if quant:  # two-level int8 + per-(token, head) f32 scales (Q-KV)
        sshape = shape[:-1] + (1,)
        i8 = dict(dtype=torch.int8, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return {"k": torch.zeros(shape, **i8), "ks": torch.ones(sshape, **f32),
                "kr": torch.zeros(shape, **i8), "krs": torch.ones(sshape, **f32),
                "v": torch.zeros(shape, **i8), "vs": torch.ones(sshape, **f32),
                "vr": torch.zeros(shape, **i8), "vrs": torch.ones(sshape, **f32)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache_lm(cfg: ArchConfig, batch: int, max_seq: int,
                  dtype=torch.float32, *, ring: bool = False,
                  global_window=None, quant: bool = False, device="cpu"):
    spec = cycle_spec(cfg)
    n_cycles, n_tail = cycle_counts(cfg)
    kw = dict(ring=ring, global_window=global_window, quant=quant,
              device=device)
    cache: Dict[str, Any] = {}
    if n_cycles:
        cache["stack"] = _stack([
            {f"b{i}": _block_cache(cfg, lt, batch, max_seq, dtype, **kw)
             for i, lt in enumerate(spec)} for _ in range(n_cycles)])
    if n_tail:
        cache["tail"] = {f"b{i}": _block_cache(cfg, spec[i], batch, max_seq,
                                               dtype, **kw)
                         for i in range(n_tail)}
    return cache


def _cache_len(tree) -> int:
    """The longest key length of a cache's K/V leaves (1 without any)."""
    n = 1
    for key, v in tree.items():
        if isinstance(v, dict):
            n = max(n, _cache_len(v))
        elif key == "k":
            n = max(n, int(v.shape[-3]))
    return n


def decode_step_lm(params, cfg: ArchConfig, cache, token, pos: int, *,
                   global_window: Optional[int] = None,
                   moe_path: str = "dispatch", ring: bool = False, tp=None):
    """One decode step. token: (B,) int; pos: int position. MoE layers run
    ``moe_path`` without the kernel (one token a sequence), as the
    reference's.

    ``tp``: the ``"model"`` rank (``distributed.sharding.DecodeRank``;
    None: one device). Each rank embeds its batch rows, runs every block
    on its heads, d_ff and SSM heads over its cache blocks (``cache`` a
    ``CacheBlocks`` and its layout), the readout on its vocabulary block,
    and gathers the logits whole (and the batch rows, where they are
    split), the same on every rank.

    Writes each layer's new k/v (a mamba layer's SSM and conv states) into
    ``cache`` in place and returns (logits (B, V), cache) — the same dict."""
    tp = tp if tp is not None else _one_device()
    layout = getattr(cache, "layout", None) if tp.mesh is not None else None
    n_batch = token.shape[0]
    x = layers.embedding_apply(
        params["embed"],
        layers.block(token, 0, tp.batch_rows(n_batch))[:, None])  # (B,1,d)
    b = tp.blocks(cfg, _cache_len(cache if layout is None
                                  else layout.shapes))
    spec = cycle_spec(cfg)
    shared = params.get("shared")
    kw = dict(tp=tp, b=b, global_window=global_window, moe_path=moe_path,
              ring=ring, n_batch=n_batch)

    def rest(part, i):
        if layout is None:
            return None
        return layout.specs[part][f"b{i}"], layout.shapes[part][f"b{i}"]

    if "stack" in params:
        for c in range(cycle_counts(cfg)[0]):
            cparams, ccache = _index(params["stack"], c), \
                _index(cache["stack"], c)
            for i, lt in enumerate(spec):
                x, _ = _block_decode(
                    _block_params(cfg, lt, cparams, i, shared), cfg, lt, x,
                    ccache[f"b{i}"], pos, rest=rest("stack", i), **kw)
    if "tail" in params:
        for i in range(cfg.num_layers % len(spec)):
            x, _ = _block_decode(
                _block_params(cfg, spec[i], params["tail"], i, shared), cfg,
                spec[i], x, cache["tail"][f"b{i}"], pos,
                rest=rest("tail", i), **kw)
    logits = tp.gather(_readout(params, cfg, x, vocab=b.vocab), 2,
                       b.vocab_sizes)
    return tp.gather_batch(logits[:, 0], 0, n_batch), cache
