"""Flash-attention forward: the CUDA kernel's wrapper.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``. It is bound by
operations (4 hd flops per query-key pair against hd elements per row); the
source note says how its design serves that. ``kernel_path`` picks a path
before launch, from dtype and head dim alone; both run on the tensor cores,
fed by TMA: ``"wgmma"`` for bf16, ``"wgmma_split"`` for f32 (a first pass
splits q, k and v into bf16 hi + lo planes, scratch that the wrapper
allocates; each product then runs as three). A call of either path counts
one launch of ``flash_attention``.

Layout (B, H, S, hd) as the reference's kernel, read through strides: the
model's (B, S, H, hd) tensors pass as transposed views, without a copy.
For tensors on the CPU the wrapper runs the plain version
(``ref.flash_attention_ref``); for CUDA tensors it launches the kernel or
raises. ``launches`` counts kernel launches, and only those;
``launches_by_path`` splits them by path.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

#: the two paths of csrc/flash_attention.cu
PATHS = ("wgmma", "wgmma_split")
#: kernel launches made by ``flash_attention`` in this process
launches = 0
#: the same, by path
launches_by_path = dict.fromkeys(PATHS, 0)

_DTYPES = (torch.float32, torch.bfloat16)
# the configs' head dims; 112 is zamba2-7b's shared block, 192 is
# nemotron-4-340b's (each an instantiation in the source)
HEAD_DIMS = (16, 32, 64, 112, 128, 192)


def kernel_path(hd: int, dtype: torch.dtype) -> str:
    """The path a CUDA call of this head dim and dtype launches:
    ``"wgmma"`` for bf16, ``"wgmma_split"`` for f32 (both take every hd in
    ``HEAD_DIMS``; the wrapper refuses any other)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    return "wgmma" if dtype == torch.bfloat16 else "wgmma_split"


def _rows_aligned(t: torch.Tensor) -> bool:
    """Last dim contiguous and every row starting 16-byte aligned."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * es) % 16 == 0 for s in t.stride()[:-1]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, hd); k/v: (B, KV, Sk, hd), H a multiple of KV, query
    head h reads kv head h // (H / KV); f32 or bf16, all one dtype and
    device -> (B, H, Sq, hd) in q's dtype and q's stride order."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B,H,Sq,hd), k and v (B,KV,Sk,hd) of one shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    path = kernel_path(hd, q.dtype)
    if Sk == 0:
        raise ValueError("flash_attention needs Sk > 0")
    if path == "wgmma_split" and max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} or k "
                         f"{tuple(k.shape)} past its split pass's 32-bit "
                         f"index limits")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    q, k, v = (t if _rows_aligned(t) else t.contiguous() for t in (q, k, v))
    if not _rows_aligned(out):
        out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dims = (ctypes.c_int64 * 6)(B, H, KV, Sq, Sk, hd)
    strides = (ctypes.c_int64 * 12)(*[s for t in (q, k, v, out)
                                      for s in t.stride()[:3]])
    opts = (int(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(hd))
    lib = _build.load("flash_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ctypes.addressof(dims), ctypes.addressof(strides))
        if path == "wgmma":
            err = lib.flash_attention_wgmma_launch(*ptrs, *opts, stream)
        else:
            # the bf16 hi and lo planes of q, k and v, each (2B, heads, S,
            # hd), in one buffer (hd % 8 == 0: each starts 16-byte aligned)
            sizes = [2 * t.numel() for t in (q, k, v)]
            planes = torch.empty(sum(sizes), dtype=torch.bfloat16, device=dev)
            at = planes.data_ptr()
            starts = [at, at + 2 * sizes[0], at + 2 * (sizes[0] + sizes[1])]
            err = lib.flash_attention_split_launch(*ptrs[:4], *starts,
                                                   *ptrs[4:], *opts, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel ({path}) launch failed: "
                           f"error {err} for q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)} {q.dtype}")
    global launches
    launches += 1
    launches_by_path[path] += 1
    return out
