"""FedAvg server aggregation x_bar = sum_c p_c * x_c: the CUDA kernel's wrapper.

The kernel (``csrc/fedavg_reduce.cu``) replaces the Pallas TPU kernel
``repro/kernels/fedavg_reduce.py::_block_reduce``. It is bound by bytes: one
read of the (N, M) client stack, one write of the (M,) average; the source
note says how the design serves that.

For a tensor on the CPU the wrapper runs the plain version
(``ref.fedavg_reduce_ref``); for a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fedavg_reduce_ref

#: kernel launches made by ``fedavg_reduce`` in this process
launches = 0

# dtype tags of csrc/fedavg_reduce.cu; int8 input (the wire path's
# decompress-reduce) will take the next tag
_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}


def fedavg_reduce(client_stack: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """client_stack: (N, M) f32/bf16, contiguous; weights: (N,) floating, on
    the same device -> (M,) in the input dtype (f32 accumulation)."""
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
    dev = client_stack.device
    if dev.type == "cpu":
        return fedavg_reduce_ref(client_stack, weights)
    if dev.type != "cuda":
        raise ValueError(f"fedavg_reduce runs on cuda or cpu, not {dev}")
    if n == 0 or m == 0:
        raise ValueError(f"fedavg_reduce needs N, M > 0, got ({n}, {m})")
    w = weights.to(torch.float32).contiguous()
    out = torch.empty((m,), dtype=client_stack.dtype, device=dev)
    lib = _build.load("fedavg_reduce")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fedavg_reduce_launch(
            client_stack.data_ptr(), w.data_ptr(), out.data_ptr(), n, m,
            _DTYPE_TAGS[client_stack.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fedavg_reduce kernel launch failed: CUDA error "
                           f"{err} for shape ({n}, {m}) {client_stack.dtype}")
    global launches
    launches += 1
    return out
