"""Plain PyTorch versions of the port's kernels.

Each is the ground truth its hand-written kernel is compared against on the
card, and what the kernel's wrapper runs for a tensor on the CPU. They
mirror the oracles of ``repro.kernels.ref``.
"""
from __future__ import annotations

import torch


def fedavg_reduce_ref(client_params: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """x: (N, M), w: (N,) -> (M,) = sum_c w_c * x_c, accumulated in f32 and
    cast to the input dtype."""
    x = client_params.to(torch.float32)
    w = weights.to(torch.float32)
    return (w[:, None] * x).sum(dim=0).to(client_params.dtype)
