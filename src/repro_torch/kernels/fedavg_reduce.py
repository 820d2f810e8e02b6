"""FedAvg server aggregation x_bar = sum_c p_c * x_c: the CUDA kernel's wrapper.

The kernel (``csrc/fedavg_reduce.cu``) replaces the Pallas TPU kernel
``repro/kernels/fedavg_reduce.py::_block_reduce``. It is bound by bytes: one
read of the (N, M) client stack, one write of the (M,) average; the source
note says how the design serves that.

``fedavg_reduce_sharded`` replaces ``fedavg_reduce_sharded`` of the same
file: each rank reduces its own client rows through the same kernel into
an f32 partial, and ``collectives.all_reduce_tiers`` (the reference's
``psum_tiers``) sums the partials across ranks, outside the kernel.

For a tensor on the CPU the wrapper runs the plain version
(``ref.fedavg_reduce_ref``); for a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches, and only those;
``sharded_launches`` counts the sharded wrapper's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.collectives import all_reduce_tiers
from repro_torch.kernels.ref import fedavg_reduce_ref

#: kernel launches made by ``fedavg_reduce`` in this process
launches = 0
#: kernel launches made by ``fedavg_reduce_sharded`` on this rank's rows
sharded_launches = 0

# dtype tags of csrc/fedavg_reduce.cu; int8 input (the wire path's
# decompress-reduce) will take the next tag
_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}


def fedavg_reduce(client_stack: torch.Tensor, weights: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """client_stack: (N, M) f32/bf16, contiguous; weights: (N,) floating, on
    the same device -> (M,) in ``out_dtype``: the input dtype (default) or
    f32 (f32 accumulation either way)."""
    if client_stack.dim() != 2:
        raise ValueError(f"client_stack must be (N, M), got shape "
                         f"{tuple(client_stack.shape)}")
    n, m = client_stack.shape
    if weights.shape != (n,):
        raise ValueError(f"weights must be ({n},), got "
                         f"{tuple(weights.shape)}")
    if client_stack.dtype not in _DTYPE_TAGS:
        raise TypeError(f"fedavg_reduce takes float32 or bfloat16, got "
                        f"{client_stack.dtype}")
    if not weights.is_floating_point():
        raise TypeError(f"weights must be floating, got {weights.dtype}")
    if weights.device != client_stack.device:
        raise ValueError(f"weights on {weights.device}, client_stack on "
                         f"{client_stack.device}")
    if not client_stack.is_contiguous():
        raise ValueError("client_stack must be contiguous")
    out_dtype = out_dtype or client_stack.dtype
    if out_dtype not in (client_stack.dtype, torch.float32):
        raise TypeError(f"fedavg_reduce writes the input dtype or float32, "
                        f"not {out_dtype}")
    dev = client_stack.device
    if dev.type == "cpu":
        return fedavg_reduce_ref(client_stack, weights, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"fedavg_reduce runs on cuda or cpu, not {dev}")
    if n == 0 or m == 0:
        raise ValueError(f"fedavg_reduce needs N, M > 0, got ({n}, {m})")
    w = weights.to(torch.float32).contiguous()
    out = torch.empty((m,), dtype=out_dtype, device=dev)
    lib = _build.load("fedavg_reduce")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fedavg_reduce_launch(
            client_stack.data_ptr(), w.data_ptr(), out.data_ptr(), n, m,
            _DTYPE_TAGS[client_stack.dtype], _DTYPE_TAGS[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"fedavg_reduce kernel launch failed: CUDA error "
                           f"{err} for shape ({n}, {m}) {client_stack.dtype} "
                           f"-> {out_dtype}")
    global launches
    launches += 1
    return out


def fedavg_reduce_sharded(client_rows: torch.Tensor, weights: torch.Tensor,
                          *, mesh, client_axes,
                          reduce_tiers=None) -> torch.Tensor:
    """This rank's client rows (n, M) f32/bf16 and their weights (n,) ->
    the (M,) weighted sum over every rank's rows, in the input dtype, on
    every rank. The rows go through the kernel into an f32 partial (a rank
    with no rows adds zeros), the partials are all-reduced over
    ``client_axes`` (flat, or one group per tier of ``reduce_tiers``), and
    the sum is cast to the input dtype."""
    if client_rows.dim() != 2:
        raise ValueError(f"client_rows must be (n, M), got shape "
                         f"{tuple(client_rows.shape)}")
    n, m = client_rows.shape
    if n:
        partial = fedavg_reduce(client_rows, weights,
                                out_dtype=torch.float32)
        if client_rows.is_cuda:
            global sharded_launches
            sharded_launches += 1
    else:
        partial = torch.zeros((m,), dtype=torch.float32,
                              device=client_rows.device)
    all_reduce_tiers(partial, mesh, client_axes, reduce_tiers)
    return partial.to(client_rows.dtype)
