"""Multi-head / grouped-query attention with the variants the dense archs
need: GQA, QKV bias, sliding window, logit softcap, RoPE, KV-cache decode
(f32 or the two-level int8 Q-KV cache) and the encoder-decoder's cross
attention, as ``repro.models.attention``.

The plain path is torch (the oracle); ``use_kernel=True`` swaps in the CUDA
flash kernel through ``kernels.ops.flash_attention``. The int8 quantisers
also serve the wire codecs (``core.engine.transport``).

Decode writes the new token's k/v into the cache tensors in place (the
reference returns new arrays): a step touches one slot per layer instead of
copying the whole cache.

In the tensor-parallel prefill ``attention`` runs one ``"model"`` rank's
share on its ``HeadBlock``: q, k and v of its heads (column blocks of the
whole leaves), the attention on those heads, and ``wo`` row-parallel. In
the tensor-parallel decode ``attention_decode`` and
``attention_decode_quant`` do, over the rank's block of the cache, which
``KVPlace`` says how to write and read. The encoder-decoder's
``bidirectional_attention`` (its encoder) and ``cross_attention`` (over
the rank's blocks of the cross cache, which ``cross_attention_kv``
computes) take the same ``HeadBlock`` and ``KVPlace``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.collectives import row_range
from repro_torch.models import layers

# masked scores: finite, as the reference (a -inf row max gives NaN)
MASKED = -1e30


def attn_init(gen, cfg: ArchConfig, dtype=torch.float32, device="cpu"):
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device)
    return {
        "wq": layers.dense_init(gen, d, cfg.num_heads * hd, **kw),
        "wk": layers.dense_init(gen, d, cfg.num_kv_heads * hd, **kw),
        "wv": layers.dense_init(gen, d, cfg.num_kv_heads * hd, **kw),
        "wo": layers.dense_init(gen, cfg.num_heads * hd, d, dtype=dtype,
                                device=device),
    }


@dataclass(frozen=True)
class HeadBlock:
    """A rank's attention heads: query heads ``q`` [h0, h1), the kv heads
    ``kv`` [k0, k1) they read (query head h reads kv head h // ``group``),
    and the kv heads ``own`` whose decode state this rank keeps, those
    whose first query head it holds (disjoint over the ranks, together
    every kv head)."""
    q: Tuple[int, int]
    kv: Tuple[int, int]
    own: Tuple[int, int]
    group: int

    def reads(self) -> Tuple[int, ...]:
        """The kv head each of the rank's query heads reads, as an index
        into its kv block."""
        (h0, h1), k0 = self.q, self.kv[0]
        return tuple(h // self.group - k0 for h in range(h0, h1))

    @property
    def aligned(self) -> bool:
        """Whether the rank's query heads read its kv heads in equal
        contiguous groups, as the flash kernel maps them inside one call
        (else the kv heads are repeated, one a query head)."""
        nq, nk = self.q[1] - self.q[0], self.kv[1] - self.kv[0]
        return nk > 0 and nq % nk == 0 and \
            self.reads() == tuple(i // (nq // nk) for i in range(nq))


def head_block(num_heads: int, num_kv_heads: int, size: int,
               rank: int) -> HeadBlock:
    """Rank ``rank`` of ``size`` ``"model"`` ranks' heads (``HeadBlock``):
    its ``row_range`` block of query heads; one rank holds every head."""
    G = num_heads // num_kv_heads
    h0, h1 = row_range(num_heads, size, rank)
    kv = (h0 // G, (h1 - 1) // G + 1) if h1 > h0 else (h0 // G, h0 // G)
    return HeadBlock((h0, h1), kv, (-(-h0 // G), -(-h1 // G)), G)


def _project_kv(p, cfg: ArchConfig, x, positions, *, rope: bool = True):
    """Every kv head's (k, v) of ``x`` (B, S, d) at ``positions``."""
    B, S, _ = x.shape
    shape = (B, S, cfg.num_kv_heads, cfg.head_dim)
    k = layers.dense_apply(p["wk"], x).reshape(shape)
    v = layers.dense_apply(p["wv"], x).reshape(shape)
    if rope:
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _gqa_scores(q, k, softcap_val: Optional[float]):
    """q: (B,Sq,H,hd), k: (B,Sk,KV,hd) -> (B,KV,G,Sq,Sk) f32; query head h
    reads kv head h // G (contiguous groups)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k) / math.sqrt(hd)
    return layers.softcap(scores.to(torch.float32), softcap_val)


def _gqa_combine(probs, v):
    """probs: (B,KV,G,Sq,Sk), v: (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    B, KV, G, Sq, Sk = probs.shape
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(probs.dtype))
    return out.reshape(B, Sq, KV * G, v.shape[-1])


def causal_mask(Sq: int, Sk: int, q_offset: int = 0,
                window: Optional[int] = None, device="cpu") -> torch.Tensor:
    """(Sq, Sk) boolean mask; True = attend. Supports sliding window."""
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    kj = torch.arange(Sk, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m


# Above this sequence length the plain path processes queries in chunks
# (the same math, a full-row softmax per query, but the (S, S) score buffer
# never materialises): the reference's constants.
QUERY_CHUNK_THRESHOLD = 2048
QUERY_CHUNK = 1024


def _attend_chunk(q, k, v, softcap_val, mask):
    """q: (B,Qc,H,hd); k/v: (B,Sk,KV,hd); mask: (Qc,Sk) or None."""
    scores = _gqa_scores(q, k, softcap_val)
    if mask is not None:
        scores = scores.masked_fill(~mask, MASKED)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return _gqa_combine(probs, v)


def _attend_chunked(q, k, v, softcap_val, window):
    """The query-chunked plain path: QUERY_CHUNK rows at a time; under
    autograd each chunk is recomputed in the backward pass (the reference's
    ``jax.checkpoint``) so the chunks' probabilities are never all held."""
    S = q.shape[1]
    outs = []
    for off in range(0, S, QUERY_CHUNK):
        mask = causal_mask(QUERY_CHUNK, S, off, window, q.device)
        q_i = q[:, off:off + QUERY_CHUNK]
        if torch.is_grad_enabled():
            outs.append(layers.remat(_attend_chunk, q_i, k, v, softcap_val,
                                     mask))
        else:
            outs.append(_attend_chunk(q_i, k, v, softcap_val, mask))
    return torch.cat(outs, dim=1)


def head_param_blocks(cfg: ArchConfig, heads: HeadBlock):
    """The blocks of the attention leaves that a rank of ``heads`` reads,
    {leaf: (dim from the end, [(lo, hi)])}: the columns of ``wq`` of its
    query heads and of ``wk``, ``wv`` of the kv heads they read, the rows
    of ``wo`` of its query heads. ``_head_project`` and ``_head_out`` cut
    these; the train step's gradients on the ranks
    (``sharding.ModelGrads``) read them."""
    hd = cfg.head_dim
    q = (heads.q[0] * hd, heads.q[1] * hd)
    kv = (heads.kv[0] * hd, heads.kv[1] * hd)
    return {"wq": (-1, [q]), "wk": (-1, [kv]), "wv": (-1, [kv]),
            "wo": (-2, [q])}


def _head_project(p, cfg: ArchConfig, x, heads: HeadBlock):
    """q of the rank's query heads and k, v of the kv heads they read, of
    ``x`` (B, S, d), no rope: column blocks of the whole leaves (the leaves
    themselves for every head)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    (h0, h1), (k0, k1) = heads.q, heads.kv
    blk = head_param_blocks(cfg, heads)
    q = layers.dense_block(p["wq"], x, blk["wq"]).reshape(B, S, h1 - h0, hd)
    k = layers.dense_block(p["wk"], x, blk["wk"]).reshape(B, S, k1 - k0, hd)
    v = layers.dense_block(p["wv"], x, blk["wv"]).reshape(B, S, k1 - k0, hd)
    return q, k, v


def _per_query_head(heads: HeadBlock, k, v):
    """k, v of the kv heads the rank reads, as its query heads map them:
    as they are where they read them in equal contiguous groups
    (``heads.aligned``), else one copy of the kv head each query head
    reads."""
    if heads.q[1] > heads.q[0] and not heads.aligned:
        idx = torch.tensor(heads.reads(), dtype=torch.long, device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx)
    return k, v


def _head_out(p, cfg: ArchConfig, heads: HeadBlock, out):
    """``wo`` row-parallel over the rank's heads' outputs ``out`` (B, S,
    heads, hd): its partial sum (every head: the output)."""
    B, S = out.shape[:2]
    h0, h1 = heads.q
    return layers.dense_block(p["wo"],
                              out.reshape(B, S, (h1 - h0) * cfg.head_dim),
                              head_param_blocks(cfg, heads)["wo"])


def attention(p, cfg: ArchConfig, x, positions, *,
              window: Optional[int] = None, use_kernel: bool = False,
              rope: bool = True, heads: Optional[HeadBlock] = None,
              kv_rows=None):
    """Full-sequence causal attention (training / prefill). Returns
    (out, (k, v)).

    ``heads`` (None: every head) is one ``"model"`` rank's share in the
    tensor-parallel prefill: q, k and v of its heads, the attention on
    them and ``wo`` row-parallel, so ``out`` is the rank's partial sum,
    which the caller reduces over the ranks, and (k, v) the kv heads it
    owns, or with ``kv_rows`` (lo, hi) every kv head at key positions
    [lo, hi) (``attn_kv_spec``'s key-sequence block). Where its query
    heads do not read its kv heads in equal groups (``heads.aligned``),
    each query head gets its own copy of the kv head it reads, so that one
    kernel call maps them as it maps whole groups."""
    if heads is None:
        heads = head_block(cfg.num_heads, cfg.num_kv_heads, 1, 0)
    S = x.shape[1]
    (h0, h1), k0 = heads.q, heads.kv[0]
    q, k, v = _head_project(p, cfg, x, heads)
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    ka, va = _per_query_head(heads, k, v)
    if h1 == h0:                      # more ranks than heads: none here
        out = q
    elif use_kernel:
        out = kops.flash_attention(q, ka, va, causal=True, window=window,
                                   softcap=cfg.attn_logit_softcap)
    elif S > QUERY_CHUNK_THRESHOLD and S % QUERY_CHUNK == 0:
        out = _attend_chunked(q, ka, va, cfg.attn_logit_softcap, window)
    else:
        mask = causal_mask(S, S, window=window, device=x.device)
        out = _attend_chunk(q, ka, va, cfg.attn_logit_softcap, mask)
    out = _head_out(p, cfg, heads, out)
    if kv_rows is not None:
        lo, hi = kv_rows
        return out, _project_kv(p, cfg, x[:, lo:hi], positions[:, lo:hi],
                                rope=rope)
    o0, o1 = heads.own
    if (o0, o1) == heads.kv:
        return out, (k, v)
    return out, (k[:, :, o0 - k0:o1 - k0].contiguous(),
                 v[:, :, o0 - k0:o1 - k0].contiguous())


def bidirectional_attention(p, cfg: ArchConfig, x, *,
                            heads: Optional[HeadBlock] = None):
    """The encoder's self-attention: every position attends to every
    other (no mask, no rope), on the plain path. ``heads`` (None: every
    head) as ``attention``'s: q, k and v of the rank's heads, ``wo``
    row-parallel, so the result is its partial sum."""
    if heads is None:
        heads = head_block(cfg.num_heads, cfg.num_kv_heads, 1, 0)
    q, k, v = _head_project(p, cfg, x, heads)
    out = q if heads.q[1] == heads.q[0] else _attend_chunk(
        q, *_per_query_head(heads, k, v), None, None)
    return _head_out(p, cfg, heads, out)


def cross_attention_init(gen, cfg: ArchConfig, dtype=torch.float32,
                         device="cpu"):
    return attn_init(gen, cfg, dtype, device)


def cross_attention(p, cfg: ArchConfig, x, enc_kv, *,
                    heads: Optional[HeadBlock] = None,
                    place: Optional[KVPlace] = None):
    """Decoder-to-encoder attention: no mask, no rope. x: (B,Sq,d);
    enc_kv: the precomputed (k, v), each (B,Senc,KV,hd).

    ``heads`` and ``place`` (None: every head, the whole cross cache) are
    one ``"model"`` rank's share: q of its query heads; ``enc_kv`` its
    blocks of the cross (k, v) as ``place`` keeps them (the kv heads its
    query heads read, or its block of the head dim or the encoder
    sequence, gathered whole by ``_read``: every rank takes part in that
    gather); ``wo`` row-parallel, so the result is its partial sum. The
    cross cache is read, never written."""
    if heads is None:
        heads = head_block(cfg.num_heads, cfg.num_kv_heads, 1, 0)
    if place is None:
        place = KVPlace(enc_kv[0].shape[1])
    B, Sq, _ = x.shape
    hd = cfg.head_dim
    h0, h1 = heads.q
    q = layers.dense_apply(p["wq"], x, cols=(h0 * hd, h1 * hd)).reshape(
        B, Sq, h1 - h0, hd)
    k, v = _read(place, enc_kv, heads.kv)
    out = q if h1 == h0 else _attend_chunk(
        q, *_per_query_head(heads, k, v), None, None)
    return _head_out(p, cfg, heads, out)


def cross_attention_kv(p, cfg: ArchConfig, enc_out,
                       place: Optional[KVPlace] = None):
    """The encoder's (k, v) for cross attention, computed once a sequence
    and read by every decode step. ``place`` (None: every kv head, whole):
    one rank's block as ``place`` keeps it, computed straight from
    ``enc_out`` with no collective: the kv heads ``span`` (dim 2: its
    columns of ``wk``/``wv``), its head-dim block of every kv head (dim
    3: those columns of each head), or its rows ``span`` of the encoder
    sequence (dim 1)."""
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    dim, span = (None, None) if place is None else (place.dim, place.span)
    if dim == 1:
        enc_out = layers.block(enc_out, 1, span)
    B, Senc, _ = enc_out.shape

    def project(leaf):
        if dim == 2:
            lo, hi = span
            return layers.dense_apply(leaf, enc_out, cols=(
                lo * hd, hi * hd)).reshape(B, Senc, hi - lo, hd)
        if dim == 3:
            lo, hi = span
            cut = {k: t.unflatten(-1, (KV, hd))[..., lo:hi].flatten(-2)
                   for k, t in leaf.items()}
            return layers.dense_apply(cut, enc_out).reshape(B, Senc, KV,
                                                            hi - lo)
        return layers.dense_apply(leaf, enc_out).reshape(B, Senc, KV, hd)

    return project(p["wk"]), project(p["wv"])


def _decode_valid(L: int, pos: int, window: Optional[int], ring: bool,
                  device) -> torch.Tensor:
    kj = torch.arange(L, device=device)
    valid = kj <= pos       # ring: only un-written slots masked (kj > pos)
    if window is not None and not ring:
        valid = valid & (kj > pos - window)
    return valid


@dataclass(frozen=True)
class KVPlace:
    """Where one rank keeps a layer's K/V decode cache (B, L, KV, hd)
    between steps (``distributed.sharding.cache_pspecs``' layout), and the
    collectives that reach it. ``length``: the whole cache's L. ``dim``:
    the dim the ranks split, 1 (the key sequence), 2 (the kv heads) or 3
    (the head dim), and ``span`` this rank's block of it; None: whole on
    this rank. ``to_heads(t)``: the new slot's kv heads that each rank
    owns (``HeadBlock.own``) put together along t's dim -2, every kv head
    on every rank (an all-gather; None where one rank owns them all).
    ``gather(t, dim)``: cache blocks stacked on a leading dim made whole
    along ``dim`` (an all-gather; None where ``dim`` is not split). One
    device: ``KVPlace(L)``."""
    length: int
    dim: Optional[int] = None
    span: Tuple[int, int] = (0, 0)
    to_heads: Optional[Callable] = None
    gather: Optional[Callable] = None


def _all_heads(place: KVPlace, ts):
    """The new slot's values ``ts`` (each (B, 1, own, .)) over every kv
    head: one ``to_heads`` for them all."""
    if place.to_heads is None:
        return list(ts)
    return list(torch.unbind(place.to_heads(torch.stack(ts)), 0))


def _put_slot(place: KVPlace, t, own, whole, slot: int) -> None:
    """Write the new slot into this rank's block ``t`` of a value leaf:
    its own kv heads (``dim`` 2), its head-dim block of every head (3),
    every head where its key block holds ``slot`` (1), or the whole
    slot."""
    if place.dim == 2:
        t[:, slot] = own[:, 0].to(t.dtype)
    elif place.dim == 1:
        lo, hi = place.span
        if lo <= slot < hi:
            t[:, slot - lo] = whole[:, 0].to(t.dtype)
    elif place.dim == 3:
        t[:, slot] = layers.block(whole[:, 0], 2, place.span).to(t.dtype)
    else:
        t[:, slot] = whole[:, 0].to(t.dtype)


def _read(place: KVPlace, ts, kv: Tuple[int, int]):
    """The kv heads ``kv`` (k0, k1) of value leaves ``ts`` over the whole
    key length, whole head dim: the blocks gathered (one ``gather`` for
    them all) where the ranks split L or hd, then cut to ``kv``."""
    if place.gather is not None:
        ts = torch.unbind(place.gather(torch.stack(ts), place.dim + 1), 0)
    if place.dim == 2:
        if place.span != kv:
            raise ValueError(f"the rank's cache block holds kv heads "
                             f"{place.span}, its query heads read {kv}")
        return list(ts)
    return [layers.block(t, 2, kv) for t in ts]


def _decode_project(p, cfg: ArchConfig, x, pos: int, heads: HeadBlock,
                    rope: bool):
    """q of the rank's query heads, k and v of the kv heads it owns, at
    position ``pos``: column blocks of the whole leaves (the leaves
    themselves for every head)."""
    B, hd = x.shape[0], cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    (h0, h1), (o0, o1) = heads.q, heads.own
    q = layers.dense_apply(p["wq"], x, cols=(h0 * hd, h1 * hd)).reshape(
        B, 1, h1 - h0, hd)
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.dense_apply(p["wk"], x, cols=(o0 * hd, o1 * hd)).reshape(
        B, 1, o1 - o0, hd)
    v = layers.dense_apply(p["wv"], x, cols=(o0 * hd, o1 * hd)).reshape(
        B, 1, o1 - o0, hd)
    if rope:
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _decode_attend(p, cfg, x, q, kd, vd, pos, window, ring, heads):
    """The rank's query heads over its kv heads' whole-length keys, then
    ``wo`` row-parallel: the rank's partial (every head: the output)."""
    out = q
    if heads.q[1] > heads.q[0]:
        kd, vd = _per_query_head(heads, kd, vd)
        scores = _gqa_scores(q, kd, cfg.attn_logit_softcap)  # (B,KV,G,1,L)
        valid = _decode_valid(kd.shape[1], pos, window, ring, x.device)
        scores = scores.masked_fill(~valid, MASKED)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = _gqa_combine(probs, vd)
    return _head_out(p, cfg, heads, out)


def attention_decode(p, cfg: ArchConfig, x, cache_k, cache_v, pos: int, *,
                     window: Optional[int] = None, rope: bool = True,
                     ring: bool = False, heads: Optional[HeadBlock] = None,
                     place: Optional[KVPlace] = None):
    """One-token decode. x: (B,1,d); cache_k/v: (B,Smax|W,KV,hd); pos: int.

    ``ring=True`` (windowed layers): the cache holds the last W tokens as a
    ring buffer, the new k/v landing at slot ``pos % W``; keys are stored
    post-RoPE, so slot order never matters.

    ``heads`` and ``place`` (None: every head, the whole cache) are one
    ``"model"`` rank's share in the tensor-parallel decode: q of its query
    heads and k, v of the kv heads it owns; the new slot written into its
    cache blocks ``cache_k``/``cache_v`` as ``place`` keeps them; its
    query heads over the kv heads they read, gathered whole along the key
    sequence or head dim where the ranks split those; ``wo``
    row-parallel, so ``out`` is the rank's partial sum, which the caller
    reduces over the ranks.

    Writes the new k/v into ``cache_k``/``cache_v`` in place and returns
    (out, cache_k, cache_v)."""
    if heads is None:
        heads = head_block(cfg.num_heads, cfg.num_kv_heads, 1, 0)
    if place is None:
        place = KVPlace(cache_k.shape[1])
    q, k, v = _decode_project(p, cfg, x, pos, heads, rope)
    slot = pos % place.length if ring else pos
    whole = _all_heads(place, (k, v)) if place.dim != 2 else (None, None)
    for t, own, w in zip((cache_k, cache_v), (k, v), whole):
        _put_slot(place, t, own, w, slot)
    kd, vd = _read(place, (cache_k, cache_v), heads.kv)
    out = _decode_attend(p, cfg, x, q, kd, vd, pos, window, ring, heads)
    return out, cache_k, cache_v


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d) -> (int8 values, per-vector f32 scale (..., 1)).

    The scale is max|x| / 127 over the last axis, floored at 1e-8;
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    x32 = x.to(torch.float32)
    scale = torch.amax(torch.abs(x32), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv_residual(x: torch.Tensor):
    """Two-level int8: the primary pass, then an int8 pass over its
    residual. Returns (q, scale, qr, rscale)."""
    q, scale = quantize_kv(x)
    residual = x.to(torch.float32) - q.to(torch.float32) * scale
    qr, rscale = quantize_kv(residual)
    return q, scale, qr, rscale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def dequantize_kv_residual(q, scale, qr, rscale, dtype):
    return (dequantize_kv(q, scale, torch.float32)
            + qr.to(torch.float32) * rscale).to(dtype)


QUANT_KEYS = ("k", "ks", "kr", "krs", "v", "vs", "vr", "vrs")
#: the int8 value leaves of the quantised cache, and their scales
QUANT_VALUES = ("k", "kr", "v", "vr")
QUANT_SCALES = ("ks", "krs", "vs", "vrs")


def attention_decode_quant(p, cfg: ArchConfig, x,
                           cache: Dict[str, torch.Tensor], pos: int, *,
                           window: Optional[int] = None, rope: bool = True,
                           ring: bool = False,
                           heads: Optional[HeadBlock] = None,
                           place: Optional[KVPlace] = None):
    """attention_decode against a two-level int8 cache
    {k,ks,kr,krs,v,vs,vr,vrs} with per-(token, head) f32 scales. Writes the
    new slot in place and returns (out, cache). ``heads`` and ``place`` as
    ``attention_decode``'s: the int8 values follow ``place``; the scales
    are whole over the ranks, each kv head's from the rank that owns it
    (which quantises over its whole head dim); int8 is gathered at use,
    then dequantised."""
    if heads is None:
        heads = head_block(cfg.num_heads, cfg.num_kv_heads, 1, 0)
    if place is None:
        place = KVPlace(cache["k"].shape[1])
    q, k, v = _decode_project(p, cfg, x, pos, heads, rope)
    slot = pos % place.length if ring else pos
    new = dict(zip(QUANT_KEYS, (*quantize_kv_residual(k),
                                *quantize_kv_residual(v))))
    own = [new[n] for n in QUANT_VALUES]
    whole = (_all_heads(place, own) if place.dim != 2
             else [None] * len(own))
    for name, o, w in zip(QUANT_VALUES, own, whole):
        _put_slot(place, cache[name], o, w, slot)
    for name, s in zip(QUANT_SCALES,
                       _all_heads(place, [new[n] for n in QUANT_SCALES])):
        cache[name][:, slot] = s[:, 0].to(cache[name].dtype)
    kq, kr, vq, vr = _read(place, [cache[n] for n in QUANT_VALUES],
                           heads.kv)
    ks, krs, vs, vrs = (layers.block(cache[n], 2, heads.kv)
                        for n in QUANT_SCALES)
    kd = dequantize_kv_residual(kq, ks, kr, krs, x.dtype)
    vd = dequantize_kv_residual(vq, vs, vr, vrs, x.dtype)
    out = _decode_attend(p, cfg, x, q, kd, vd, pos, window, ring, heads)
    return out, cache
