"""The int8 quantisers of ``repro.models.attention`` (Q-KV): per-vector
max/127 scales, round half to even, clip to +-127.

The wire codecs (``core.engine.transport``) quantise flattened deltas with
them. The attention layers themselves arrive with the LM slice.
"""
from __future__ import annotations

from typing import Tuple

import torch


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
