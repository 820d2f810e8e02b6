"""Decoder-only LM for the dense, MoE, SSM, hybrid and vision-language
architectures (``repro.models.transformer``; the encoder-decoder family is
``models/encdec.py``).

Layers are grouped into *cycles*, one repetition of ``cfg.layer_pattern``
(e.g. (local, global) for gemma2, five mamba and a shared attention block
for zamba2). The params of all cycles are stacked on a leading axis under
``params["stack"]["b{i}"]`` with the reference's keys, so
``bridge.params_from_jax`` maps a reference tree 1:1; the reference's
``lax.scan`` over cycles is a loop over that axis, and ``remat``
checkpoints one cycle at a time (``torch.utils.checkpoint``) when autograd
is on.

A vision-language model (``arch_type`` "vlm") takes its patch embeddings
(the stub vision frontend's output) ahead of the text tokens; the loss
skips those prefix positions. An MoE block
holds ``moe`` (``models/moe.py``) where a dense block holds ``mlp``; its
load-balance aux is summed over the layers and never kept in the decode
states. A mamba block holds ``{"ln", "ssm"}`` (``models/ssm.py``) and its
decode state is ``{"ssm", "conv"}``. A hybrid's ``attn`` positions all run
the one block in ``params["shared"]`` (absent from the stack) and each
keeps its own KV cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
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


def _block_apply(bp, cfg: ArchConfig, ltype: str, x, positions, *,
                 global_window=None, moe_path="dispatch", use_kernel=False):
    """Full-sequence block. Returns (x, decode state + {aux}): the caller
    pops the MoE aux out of the decode state."""
    if ltype == "mamba":
        h, state = ssm_lib.ssm_forward(
            bp["ssm"], cfg, layers.norm_apply(cfg.norm_type, bp["ln"], x),
            use_kernel=use_kernel)
        state["aux"] = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + h, state
    window = _layer_window(cfg, ltype, global_window)
    h, (k, v) = attention.attention(
        bp["attn"], cfg, layers.norm_apply(cfg.norm_type, bp["ln1"], x),
        positions, window=window, use_kernel=use_kernel)
    x = x + h
    hn = layers.norm_apply(cfg.norm_type, bp["ln2"], x)
    if "moe" in bp:
        h, aux = moe_lib.moe_apply(bp["moe"], cfg, hn, path=moe_path,
                                   use_kernel=use_kernel)
    else:
        h = layers.mlp_apply(bp["mlp"], hn, cfg.mlp_type)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, {"k": k, "v": v, "aux": aux}


def _block_decode(bp, cfg: ArchConfig, ltype: str, x, state, pos, *,
                  global_window=None, moe_path="dense", ring=False):
    """One token through one block; writes its cache slot (a mamba block:
    its SSM and conv states) in place."""
    if ltype == "mamba":
        h, new = ssm_lib.ssm_decode_step(
            bp["ssm"], cfg, layers.norm_apply(cfg.norm_type, bp["ln"], x),
            state)
        state["ssm"].copy_(new["ssm"])
        state["conv"].copy_(new["conv"])
        return x + h, state
    window = _layer_window(cfg, ltype, global_window)
    use_ring = ring and window is not None
    xn = layers.norm_apply(cfg.norm_type, bp["ln1"], x)
    if "ks" in state:        # two-level int8 cache (Q-KV)
        h, state = attention.attention_decode_quant(
            bp["attn"], cfg, xn, state, pos, window=window, ring=use_ring)
    else:
        h, _, _ = attention.attention_decode(
            bp["attn"], cfg, xn, state["k"], state["v"], pos, window=window,
            ring=use_ring)
    x = x + h
    hn = layers.norm_apply(cfg.norm_type, bp["ln2"], x)
    if "moe" in bp:
        h, _ = moe_lib.moe_apply(bp["moe"], cfg, hn, path=moe_path)
    else:
        h = layers.mlp_apply(bp["mlp"], hn, cfg.mlp_type)
    return x + h, state


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


def forward_lm(params, cfg: ArchConfig, tokens, patch_embeds=None, *,
               global_window: Optional[int] = None, remat: bool = False,
               moe_path: str = "dispatch", use_kernel: bool = False,
               return_states: bool = False, return_features: bool = False):
    """Full-sequence forward. Returns (logits|features, aux[, decode
    states]); states are stacked over cycles like the params, and aux is
    the MoE load-balance loss summed over the layers (0 for dense).
    ``patch_embeds``: a vlm's (B, P, d) patch embeddings, read ahead of
    the tokens."""
    x, positions, _ = embed_inputs(params, cfg, tokens, patch_embeds)
    kw = dict(global_window=global_window, moe_path=moe_path,
              use_kernel=use_kernel)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared")
    stack_states = None
    if "stack" in params:
        per_cycle, auxs = [], []
        for cparams in _unbind(params["stack"]):
            if remat and torch.is_grad_enabled():
                x, st, a = torch.utils.checkpoint.checkpoint(
                    _cycle_apply, cparams, shared, cfg, x, positions, kw,
                    use_reentrant=False)
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
    out = x if return_features else _readout(params, cfg, x)
    if return_states:
        return out, aux, {"stack": stack_states, "tail": tail_states}
    return out, aux


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


def _readout(params, cfg: ArchConfig, x):
    x = layers.norm_apply(cfg.norm_type, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = layers.embedding_attend(params["embed"], x)
    else:
        logits = layers.dense_apply(params["lm_head"], x)
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
    for off in range(0, S + pad, chunk):
        args = (params, cfg, feats[:, off:off + chunk],
                targets[:, off:off + chunk], mask[:, off:off + chunk])
        if torch.is_grad_enabled():
            n, m = torch.utils.checkpoint.checkpoint(_chunk_nll, *args,
                                                     use_reentrant=False)
        else:
            n, m = _chunk_nll(*args)
        nll, msum = nll + n, msum + m
    return nll / torch.clamp(msum, min=1.0)


def loss_lm(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, moe_path: str = "dispatch",
            use_kernel: bool = False):
    """Next-token LM loss plus ``router_aux_coef`` x the MoE aux. batch:
    {tokens, [patch_embeds], [mask]}. Returns (loss, {"xent", "aux"})."""
    tokens = batch["tokens"]
    patch = batch.get("patch_embeds")
    feats, aux = forward_lm(params, cfg, tokens, patch, remat=remat,
                            moe_path=moe_path, use_kernel=use_kernel,
                            return_features=True)
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


def decode_step_lm(params, cfg: ArchConfig, cache, token, pos: int, *,
                   global_window: Optional[int] = None,
                   moe_path: str = "dispatch", ring: bool = False):
    """One decode step. token: (B,) int; pos: int position. MoE layers run
    ``moe_path`` without the kernel (one token a sequence), as the
    reference's.

    Writes each layer's new k/v (a mamba layer's SSM and conv states) into
    ``cache`` in place and returns (logits (B, V), cache) — the same dict."""
    x = layers.embedding_apply(params["embed"], token[:, None])   # (B,1,d)
    spec = cycle_spec(cfg)
    shared = params.get("shared")
    kw = dict(global_window=global_window, moe_path=moe_path, ring=ring)
    if "stack" in params:
        for c in range(cycle_counts(cfg)[0]):
            cparams, ccache = _index(params["stack"], c), \
                _index(cache["stack"], c)
            for i, lt in enumerate(spec):
                x, _ = _block_decode(
                    _block_params(cfg, lt, cparams, i, shared), cfg, lt, x,
                    ccache[f"b{i}"], pos, **kw)
    if "tail" in params:
        for i in range(cfg.num_layers % len(spec)):
            x, _ = _block_decode(
                _block_params(cfg, spec[i], params["tail"], i, shared), cfg,
                spec[i], x, cache["tail"][f"b{i}"], pos, **kw)
    logits = _readout(params, cfg, x)
    return logits[:, 0], cache
