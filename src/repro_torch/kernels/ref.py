"""Plain PyTorch versions of the port's kernels.

Each is the ground truth its hand-written kernel is compared against on the
card, and what the kernel's wrapper runs for a tensor on the CPU. They
mirror the oracles of ``repro.kernels.ref`` and ``repro.kernels.delta_codec``.
"""
from __future__ import annotations

from typing import Optional

import torch


def fedavg_reduce_ref(client_params: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """x: (N, M), w: (N,) -> (M,) = sum_c w_c * x_c, accumulated in f32 and
    cast to the input dtype."""
    x = client_params.to(torch.float32)
    w = weights.to(torch.float32)
    return (w[:, None] * x).sum(dim=0).to(client_params.dtype)


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
