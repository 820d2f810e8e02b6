"""Plain PyTorch versions of the port's kernels.

Each is the ground truth its hand-written kernel is compared against on the
card, and what the kernel's wrapper runs for a tensor on the CPU. They
mirror the oracles of ``repro.kernels.ref`` and ``repro.kernels.delta_codec``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.collectives import (all_gather_flat,
                                             all_reduce_tiers, axes_size,
                                             client_rank)


def fedavg_reduce_ref(client_params: torch.Tensor, weights: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """x: (N, M), w: (N,) -> (M,) = sum_c w_c * x_c, accumulated in f32 and
    cast to ``out_dtype`` (default: the input dtype)."""
    x = client_params.to(torch.float32)
    w = weights.to(torch.float32)
    return (w[:, None] * x).sum(dim=0).to(out_dtype or client_params.dtype)


def attention_mask(sq: int, sk: int, causal: bool, window: Optional[int],
                   device) -> torch.Tensor:
    """(Sq, Sk) boolean, True = attend; query and key positions both count
    from 0: causal ``kj <= qi``, a window adds ``kj > qi - window``."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd), H = KV * G, query head h
    reads kv head h // G -> (B, H, Sq, hd) in q's dtype. Scores in f32,
    scaled by 1/sqrt(hd), softcapped, masked to the finite -1e30, softmax
    over the keys."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, hd).to(torch.float32)
    scores = torch.einsum("bkgqh,bksh->bkgqs", qg,
                          k.to(torch.float32)) / math.sqrt(hd)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", probs, v.to(torch.float32))
    return out.reshape(B, H, Sq, hd).to(q.dtype)


def int8_decompress_reduce_ref(q: torch.Tensor, w_eff: torch.Tensor,
                               qr: Optional[torch.Tensor] = None,
                               wr_eff: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """q (N, M) int8, w_eff (N,) = weights * per-client scales -> (M,) f32
    sum_c w_eff_c q_c, plus the residual plane's sum when ``qr`` is given."""
    out = (w_eff.to(torch.float32)[:, None] * q.to(torch.float32)).sum(0)
    if qr is not None:
        out = out + (wr_eff.to(torch.float32)[:, None]
                     * qr.to(torch.float32)).sum(0)
    return out


def int8_decode_apply_ref(ref: torch.Tensor, q: torch.Tensor,
                          s: torch.Tensor, qr: Optional[torch.Tensor] = None,
                          rs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ref (M,); q (M,) int8; s a one-element f32 scale -> (M,)
    ``ref + q*s [+ qr*rs]`` in f32, cast to ``ref.dtype``."""
    out = ref.to(torch.float32) + q.to(torch.float32) * s.reshape(())
    if qr is not None:
        out = out + qr.to(torch.float32) * rs.reshape(())
    return out.to(ref.dtype)


def _in_range(idx: torch.Tensor, vals: torch.Tensor, size: int):
    """Indices outside [0, size) (the -1 padding) match no output: they add
    0 at index 0 instead."""
    keep = (idx >= 0) & (idx < size)
    return (torch.where(keep, idx, 0).to(torch.int64),
            torch.where(keep, vals, 0.0))


def topk_scatter_reduce_ref(vals: torch.Tensor, idx: torch.Tensor,
                            weights: torch.Tensor, size: int) -> torch.Tensor:
    """vals/idx (N, S), weights (N,) -> (M,) f32 ``out[idx] += w_c * v`` into
    zeros, one client row after the other (the kernel's order)."""
    out = torch.zeros((size,), dtype=torch.float32, device=vals.device)
    if size == 0:
        return out
    w = weights.to(torch.float32)
    for c in range(vals.shape[0]):
        i, v = _in_range(idx[c], vals[c].to(torch.float32) * w[c], size)
        out.index_add_(0, i, v)
    return out


def topk_scatter_apply_ref(ref: torch.Tensor, vals: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """ref (M,); vals/idx (S,) -> ref with ``vals`` added at ``idx``, in f32,
    cast to ``ref.dtype``."""
    out = ref.to(torch.float32).clone()
    if out.numel() == 0:
        return out.to(ref.dtype)
    i, v = _in_range(idx, vals.to(torch.float32), out.shape[0])
    out.index_add_(0, i, v)
    return out.to(ref.dtype)



# the client-sharded forms: the plain body on this rank's rows or slice,
# then the same collectives as the kernels' sharded wrappers

def fedavg_reduce_sharded_ref(client_rows: torch.Tensor,
                              weights: torch.Tensor, *, mesh, client_axes,
                              reduce_tiers=None) -> torch.Tensor:
    """``kernels.fedavg_reduce.fedavg_reduce_sharded`` in plain PyTorch."""
    partial = fedavg_reduce_ref(client_rows, weights, torch.float32)
    return all_reduce_tiers(partial, mesh, client_axes,
                            reduce_tiers).to(client_rows.dtype)


def int8_decompress_reduce_sharded_ref(q, w_eff, qr=None, wr_eff=None, *,
                                       mesh, client_axes,
                                       reduce_tiers=None) -> torch.Tensor:
    """``delta_codec.int8_decompress_reduce_sharded`` in plain PyTorch."""
    return all_reduce_tiers(int8_decompress_reduce_ref(q, w_eff, qr, wr_eff),
                            mesh, client_axes, reduce_tiers)


def int8_decode_apply_sharded_ref(ref, q, s, qr=None, rs=None, *, mesh,
                                  axes) -> torch.Tensor:
    """``delta_codec.int8_decode_apply_sharded`` in plain PyTorch."""
    m, size = ref.shape[0], axes_size(mesh, axes)
    if m % size:
        raise ValueError(f"M={m} is not a multiple of {size} ranks")
    lo = client_rank(mesh, axes) * (m // size)
    cut = lambda t: None if t is None else t[lo:lo + m // size]
    return all_gather_flat(int8_decode_apply_ref(cut(ref), cut(q), s,
                                                 cut(qr), rs), mesh, axes)


def topk_scatter_reduce_sharded_ref(vals, idx, weights, size: int, *, mesh,
                                    client_axes,
                                    reduce_tiers=None) -> torch.Tensor:
    """``delta_codec.topk_scatter_reduce_sharded`` in plain PyTorch."""
    return all_reduce_tiers(topk_scatter_reduce_ref(vals, idx, weights, size),
                            mesh, client_axes, reduce_tiers)

def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul: x (E, C, d) @ w (E, d, f) -> (E, C, f), in f32 and
    cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)


def moe_ffn_ref(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                down: torch.Tensor, *, mlp_type: str = "swiglu"
                ) -> torch.Tensor:
    """The gated expert FFN on dispatched tokens: x (E, C, d) -> (E, C, d).
    The activation runs in f32 and casts to x's dtype before ``down``."""
    if mlp_type == "swiglu":
        h = torch.nn.functional.silu(gmm_ref(x, gate).to(torch.float32))
        h = h * gmm_ref(x, up).to(torch.float32)
    else:
        h = torch.nn.functional.gelu(gmm_ref(x, up).to(torch.float32),
                                     approximate="tanh")
    return gmm_ref(h.to(x.dtype), down)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, D: torch.Tensor, *,
                 chunk: int):
    """Mamba2 SSD chunked scan (``repro.models.ssm.ssd_chunked``), in f32.

    x (B, S, H, P) per-head inputs; dt (B, S, H) step sizes; A (H,) negative
    decay rates; b/c (B, S, N) input and output projections, shared by the
    heads (one group); D (H,) skip. Returns y (B, S, H, P) in x's dtype and
    the final state (B, H, N, P) in f32.

    S is padded with zeros to a multiple of ``chunk`` (dt = 0 there, so the
    state does not change) and y is cut back. Within a chunk of Q steps,
    with cs the cumsum of dt*A:
    ``y_i = sum_{j<=i} (C_i.B_j) exp(cs_i - cs_j) dt_j x_j
    + exp(cs_i) C_i.S_prev + D x_i``; the chunk's state
    ``S = exp(cs_last) S_prev + sum_j exp(cs_last - cs_j) dt_j B_j x_j^T``
    carries to the next chunk in a loop. The decay's exponent is masked to
    -inf above the diagonal before ``exp``, so nothing overflows to inf,
    there or in the backward pass.
    """
    out_dtype = x.dtype
    x, dt, A, b, c, D = (t.to(torch.float32) for t in (x, dt, A, b, c, D))
    Bsz, S, H, P = x.shape
    N = b.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    NC = (S + pad) // chunk
    # heads ahead of the chunk's steps: (B, NC, H, Q, *)
    xc = x.reshape(Bsz, NC, chunk, H, P).transpose(2, 3)
    dtc = dt.reshape(Bsz, NC, chunk, H).transpose(2, 3)
    bc = b.reshape(Bsz, NC, chunk, N)
    cc = c.reshape(Bsz, NC, chunk, N)
    cs = torch.cumsum(dtc * A[:, None], dim=-1)               # (B,NC,H,Q)

    # intra-chunk: ((C B^T) o L) (x dt), L[i, j] = exp(cs_i - cs_j), i >= j
    cb = cc @ bc.transpose(-1, -2)                            # (B,NC,Q,Q)
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    expo = torch.where(causal, cs[..., :, None] - cs[..., None, :],
                       -math.inf)                             # (B,NC,H,Q,Q)
    gate = torch.exp(expo) * cb[:, :, None]
    xdt = xc * dtc[..., None]                                 # (B,NC,H,Q,P)
    y = gate @ xdt

    # chunk states: sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j
    last = cs[..., -1:]                                       # (B,NC,H,1)
    w = torch.exp(last - cs) * dtc                            # (B,NC,H,Q)
    states = (bc[:, :, None] * w[..., None]).transpose(-1, -2) @ xc

    # inter-chunk recurrence over the chunks
    decay = torch.exp(last[..., 0])                           # (B,NC,H)
    st = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    prev = []
    for k in range(NC):
        prev.append(st)
        st = st * decay[:, k, :, None, None] + states[:, k]
    prev = torch.stack(prev, dim=1)                           # (B,NC,H,N,P)

    # inter-chunk output: exp(cs_i) C_i . S_prev
    y = y + torch.exp(cs)[..., None] * (cc[:, :, None] @ prev)
    y = y + xc * D[:, None, None]
    y = y.transpose(2, 3).reshape(Bsz, S + pad, H, P)[:, :S]
    return y.to(out_dtype), st
