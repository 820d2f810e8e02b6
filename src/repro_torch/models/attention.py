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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
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


def _project_qkv(p, cfg: ArchConfig, x, positions, *, rope: bool = True):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = layers.dense_apply(p["wq"], x).reshape(B, S, cfg.num_heads, hd)
    k = layers.dense_apply(p["wk"], x).reshape(B, S, cfg.num_kv_heads, hd)
    v = layers.dense_apply(p["wv"], x).reshape(B, S, cfg.num_kv_heads, hd)
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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
            outs.append(torch.utils.checkpoint.checkpoint(
                _attend_chunk, q_i, k, v, softcap_val, mask,
                use_reentrant=False))
        else:
            outs.append(_attend_chunk(q_i, k, v, softcap_val, mask))
    return torch.cat(outs, dim=1)


def attention(p, cfg: ArchConfig, x, positions, *,
              window: Optional[int] = None, use_kernel: bool = False,
              rope: bool = True):
    """Full-sequence causal attention (training / prefill). Returns
    (out, (k, v))."""
    q, k, v = _project_qkv(p, cfg, x, positions, rope=rope)
    B, S = x.shape[:2]
    if use_kernel:
        out = kops.flash_attention(q, k, v, causal=True, window=window,
                                   softcap=cfg.attn_logit_softcap)
    elif S > QUERY_CHUNK_THRESHOLD and S % QUERY_CHUNK == 0:
        out = _attend_chunked(q, k, v, cfg.attn_logit_softcap, window)
    else:
        mask = causal_mask(S, k.shape[1], window=window, device=x.device)
        out = _attend_chunk(q, k, v, cfg.attn_logit_softcap, mask)
    out = layers.dense_apply(p["wo"], out.reshape(B, S, -1))
    return out, (k, v)


def cross_attention_init(gen, cfg: ArchConfig, dtype=torch.float32,
                         device="cpu"):
    return attn_init(gen, cfg, dtype, device)


def cross_attention(p, cfg: ArchConfig, x, enc_kv):
    """Decoder-to-encoder attention: no mask, no rope. x: (B,Sq,d); enc_kv:
    the precomputed (k, v), each (B,Senc,KV,hd)."""
    B, Sq, _ = x.shape
    q = layers.dense_apply(p["wq"], x).reshape(B, Sq, cfg.num_heads,
                                               cfg.head_dim)
    out = _attend_chunk(q, *enc_kv, None, None)
    return layers.dense_apply(p["wo"], out.reshape(B, Sq, -1))


def cross_attention_kv(p, cfg: ArchConfig, enc_out):
    """The encoder's (k, v) for cross attention, computed once a sequence
    and read by every decode step."""
    B, Senc, _ = enc_out.shape
    shape = (B, Senc, cfg.num_kv_heads, cfg.head_dim)
    return (layers.dense_apply(p["wk"], enc_out).reshape(shape),
            layers.dense_apply(p["wv"], enc_out).reshape(shape))


def _decode_valid(L: int, pos: int, window: Optional[int], ring: bool,
                  device) -> torch.Tensor:
    kj = torch.arange(L, device=device)
    valid = kj <= pos       # ring: only un-written slots masked (kj > pos)
    if window is not None and not ring:
        valid = valid & (kj > pos - window)
    return valid


def _decode_attend(p, cfg, x, q, kd, vd, pos, window, ring):
    B = x.shape[0]
    scores = _gqa_scores(q, kd, cfg.attn_logit_softcap)       # (B,KV,G,1,L)
    valid = _decode_valid(kd.shape[1], pos, window, ring, x.device)
    scores = scores.masked_fill(~valid, MASKED)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_combine(probs, vd)
    return layers.dense_apply(p["wo"], out.reshape(B, 1, -1))


def attention_decode(p, cfg: ArchConfig, x, cache_k, cache_v, pos: int, *,
                     window: Optional[int] = None, rope: bool = True,
                     ring: bool = False):
    """One-token decode. x: (B,1,d); cache_k/v: (B,Smax|W,KV,hd); pos: int.

    ``ring=True`` (windowed layers): the cache holds the last W tokens as a
    ring buffer, the new k/v landing at slot ``pos % W``; keys are stored
    post-RoPE, so slot order never matters.

    Writes the new k/v into ``cache_k``/``cache_v`` in place and returns
    (out, cache_k, cache_v)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions, rope=rope)
    slot = pos % cache_k.shape[1] if ring else pos
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    out = _decode_attend(p, cfg, x, q, cache_k, cache_v, pos, window, ring)
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


def attention_decode_quant(p, cfg: ArchConfig, x, cache: Dict[str, torch.Tensor],
                           pos: int, *, window: Optional[int] = None,
                           rope: bool = True, ring: bool = False):
    """attention_decode against a two-level int8 cache
    {k,ks,kr,krs,v,vs,vr,vrs} with per-(token, head) f32 scales. Writes the
    new slot in place and returns (out, cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions, rope=rope)
    slot = pos % cache["k"].shape[1] if ring else pos
    vals = (*quantize_kv_residual(k), *quantize_kv_residual(v))
    for name, val in zip(QUANT_KEYS, vals):
        cache[name][:, slot] = val[:, 0].to(cache[name].dtype)
    kd = dequantize_kv_residual(cache["k"], cache["ks"], cache["kr"],
                                cache["krs"], x.dtype)
    vd = dequantize_kv_residual(cache["v"], cache["vs"], cache["vr"],
                                cache["vrs"], x.dtype)
    out = _decode_attend(p, cfg, x, q, kd, vd, pos, window, ring)
    return out, cache
