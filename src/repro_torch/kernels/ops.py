"""Public entry points of the port's kernels (the names of
``repro.kernels.ops``). Each dispatches by the tensor's device: the
hand-written kernel on CUDA, the plain version on the CPU."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels import delta_codec as _dc
from repro_torch.kernels import fedavg_reduce as _fr
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _mg
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref
from repro_torch.optim import tree_leaves, tree_map

PyTree = Any


def fedavg_reduce(client_stack: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """(N, M) x (N,) -> (M,)."""
    return _fr.fedavg_reduce(client_stack, weights)


def fedavg_reduce_tree(client_params: PyTree, weights: torch.Tensor) -> PyTree:
    """Weighted-average every leaf of a client-stacked param dict: (N, ...)
    -> (...). On CUDA, one launch for all leaves of one dtype (up to
    ``fedavg_reduce.MAX_LEAVES`` a launch); a contiguous leaf is read in
    place, and each output equals ``fedavg_reduce`` on its leaf bitwise."""
    leaves = tree_leaves(client_params)
    outs = iter(_fr.fedavg_reduce_stacks(
        [x.reshape(x.shape[0], -1).contiguous() for x in leaves], weights))
    return tree_map(lambda x: next(outs).reshape(x.shape[1:]), client_params)


def fedavg_reduce_sharded(client_rows: torch.Tensor, weights: torch.Tensor,
                          *, mesh, client_axes,
                          reduce_tiers=None) -> torch.Tensor:
    """(n, M) rows of this rank x (n,) -> (M,) over every rank's rows: the
    kernel on this rank's rows into an f32 partial, then the all-reduce
    over the client axes (``reduce_tiers``: one group per tier)."""
    return _fr.fedavg_reduce_sharded(client_rows, weights, mesh=mesh,
                                     client_axes=client_axes,
                                     reduce_tiers=reduce_tiers)


def fedavg_reduce_tree_sharded(client_params: PyTree, weights: torch.Tensor,
                               *, mesh, client_axes,
                               reduce_tiers=None) -> PyTree:
    """The weighted average of a client-stacked param dict whose client
    rows are spread over the ranks (``MeshBackend``'s ``kernel``
    aggregator): one sharded reduce per leaf, (n, ...) -> (...)."""
    if isinstance(client_params, dict):
        return {k: fedavg_reduce_tree_sharded(
            v, weights, mesh=mesh, client_axes=client_axes,
            reduce_tiers=reduce_tiers) for k, v in client_params.items()}
    n = client_params.shape[0]
    flat = client_params.reshape(n, -1).contiguous()
    return fedavg_reduce_sharded(
        flat, weights, mesh=mesh, client_axes=client_axes,
        reduce_tiers=reduce_tiers).reshape(client_params.shape[1:])


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


def int8_delta_reduce_sharded(q: torch.Tensor, w_eff: torch.Tensor,
                              qr: Optional[torch.Tensor] = None,
                              wr_eff: Optional[torch.Tensor] = None, *, mesh,
                              client_axes, reduce_tiers=None) -> torch.Tensor:
    """The int8 reduce with the client rows spread over the ranks: the
    fused kernel on this rank's rows, then the all-reduce of the f32
    partials."""
    return _dc.int8_decompress_reduce_sharded(
        q, w_eff, qr, wr_eff, mesh=mesh, client_axes=client_axes,
        reduce_tiers=reduce_tiers)


def topk_delta_reduce_sharded(vals: torch.Tensor, idx: torch.Tensor,
                              weights: torch.Tensor, size: int, *, mesh,
                              client_axes, reduce_tiers=None) -> torch.Tensor:
    """The top-k reduce with the payload rows spread over the ranks: the
    scatter-add kernel on this rank's rows, then the all-reduce of the f32
    partials."""
    return _dc.topk_scatter_reduce_sharded(vals, idx, weights, size,
                                           mesh=mesh,
                                           client_axes=client_axes,
                                           reduce_tiers=reduce_tiers)


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


def int8_delta_apply_sharded(ref: torch.Tensor, q: torch.Tensor,
                             s: torch.Tensor,
                             qr: Optional[torch.Tensor] = None,
                             rs: Optional[torch.Tensor] = None, *, mesh,
                             axes) -> torch.Tensor:
    """The downlink reconstruction with the (M,) vector cut into one slice
    a rank (M a multiple of the ranks): the kernel on each slice, then one
    all-gather."""
    return _dc.int8_decode_apply_sharded(ref, q, s, qr, rs, mesh=mesh,
                                         axes=axes)


def topk_delta_apply(ref: torch.Tensor, vals: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """Downlink top-k reconstruction: the kept coordinates scatter-added
    into a copy of the broadcast reference."""
    return _dc.topk_scatter_apply(ref, vals, idx)


# ---------------------------------------------------------------------------
# flash attention (model layout adapter)
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Forward through the kernel (the plain version on the CPU); backward
    by autograd through the plain version, as the reference's custom VJP
    differentiates its jnp oracle."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, softcap)
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        causal, window, softcap = ctx.opts
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = flash_attention_ref(*leaves, causal=causal, window=window,
                                      softcap=softcap)
        grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Model layout: q (B, Sq, H, hd); k/v (B, Sk, KV, hd) -> (B, Sq, H, hd).

    The attention layer calls this when ``use_kernel=True``. The kernel
    reads the transposed views through their strides, so nothing is
    copied, and takes any S and hd in ``flash_attention.HEAD_DIMS`` (16,
    32, 64, 112, 128, 192): the reference's padding to 128 was TPU
    tiling."""
    out = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal, window, softcap)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# MoE grouped matmul
# ---------------------------------------------------------------------------

def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, d) @ (E, d, f) -> (E, C, f) in x's dtype. The kernel takes any
    C: the reference's padding of C to 128 was TPU tiling."""
    return _mg.gmm(x, w)


def moe_gmm(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
            down: torch.Tensor, *, mlp_type: str = "swiglu") -> torch.Tensor:
    """The gated expert FFN on dispatched tokens, three grouped matmuls:
    x (E, C, d) -> (E, C, d). The activation runs in f32 and casts to x's
    dtype before ``down``, as the reference's."""
    if mlp_type == "swiglu":
        h = torch.nn.functional.silu(gmm(x, gate).to(torch.float32))
        h = (h * gmm(x, up).to(torch.float32)).to(x.dtype)
    else:
        h = torch.nn.functional.gelu(gmm(x, up).to(torch.float32),
                                     approximate="tanh").to(x.dtype)
    return gmm(h, down)


# ---------------------------------------------------------------------------
# SSD scan (model layout adapter)
# ---------------------------------------------------------------------------

class _SsdScan(torch.autograd.Function):
    """Forward through the kernel (the plain version on the CPU); backward
    by autograd through the plain version (the reference's Pallas scan has
    no backward kernel; its model differentiates ``ssd_chunked``)."""

    @staticmethod
    def forward(ctx, x, dt, A, b, c, D, chunk):
        ctx.save_for_backward(x, dt, A, b, c, D)
        ctx.chunk = chunk
        return _ssd.ssd_scan(x, dt, A, b, c, D, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            outs = ssd_scan_ref(*leaves, chunk=ctx.chunk)
        grads = torch.autograd.grad(outs, leaves, (gy, gstate))
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             chunk: int = 256):
    """Model layout (as ``models.ssm.ssd_chunked``): x (B, S, H, P); dt
    (B, S, H); a_log = A (H,) negative rates; b/c (B, S, N); d (H,). Returns
    (y (B, S, H, P) in x's dtype, state (B, H, N, P) f32).

    The kernel reads these tensors in place: the reference's per-(batch,
    head) copies, its broadcast of b and c to every head and its zero
    padding of S were TPU layout."""
    return _SsdScan.apply(x, dt, a_log, b, c, d, chunk)
