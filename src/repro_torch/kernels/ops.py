"""Public entry points of the port's kernels (the names of
``repro.kernels.ops``). Each dispatches by the tensor's device: the
hand-written kernel on CUDA, the plain version on the CPU."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels import delta_codec as _dc
from repro_torch.kernels import fedavg_reduce as _fr

PyTree = Any


def fedavg_reduce(client_stack: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """(N, M) x (N,) -> (M,)."""
    return _fr.fedavg_reduce(client_stack, weights)


def fedavg_reduce_tree(client_params: PyTree, weights: torch.Tensor) -> PyTree:
    """Weighted-average every leaf of a client-stacked param dict, one
    launch per leaf: (N, ...) -> (...)."""
    if isinstance(client_params, dict):
        return {k: fedavg_reduce_tree(v, weights)
                for k, v in client_params.items()}
    n = client_params.shape[0]
    flat = client_params.reshape(n, -1).contiguous()
    return fedavg_reduce(flat, weights).reshape(client_params.shape[1:])


# ---------------------------------------------------------------------------
# compressed-delta transport (the wire path)
# ---------------------------------------------------------------------------

def int8_delta_reduce(q: torch.Tensor, w_eff: torch.Tensor,
                      qr: Optional[torch.Tensor] = None,
                      wr_eff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused dequantise + weighted reduce of an int8 client-delta stack:
    q (N, M) int8, w_eff (N,) = weights * per-client scales -> (M,) f32.
    The optional residual plane reduces in the same pass."""
    return _dc.int8_decompress_reduce(q, w_eff, qr, wr_eff)


def topk_delta_reduce(vals: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor, size: int) -> torch.Tensor:
    """Weighted scatter-add reduction of top-k payloads (N, S) -> (M,) f32."""
    return _dc.topk_scatter_reduce(vals, idx, weights, size)


def int8_delta_apply(ref: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     qr: Optional[torch.Tensor] = None,
                     rs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Downlink reconstruction ``ref + q*s [+ qr*rs]``: ref (M,) -> (M,) in
    ``ref.dtype``."""
    return _dc.int8_decode_apply(ref, q, s, qr, rs)


def topk_delta_apply(ref: torch.Tensor, vals: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Downlink top-k reconstruction: the kept coordinates scatter-added
    into a copy of the broadcast reference."""
    return _dc.topk_scatter_apply(ref, vals, idx)
