"""Grouped matmul of the MoE expert FFN: the CUDA kernel's wrapper.

The kernels (``csrc/moe_gmm.cu``) replace the Pallas TPU kernel
``repro/kernels/moe_gmm.py::gmm``: ``out[e] = x[e] @ w[e]`` for x (E, C, d)
and w (E, d, f), summed in f32 and stored in x's dtype. They are bound by
operations at the shapes the MoE prefill gives them; the source note says
how each design serves that. ``kernel_path`` picks one before launch, from
dtype and shape alone. With d and f multiples of 8, both run on the tensor
cores, fed by TMA: ``"wgmma"`` for bf16 and ``"wgmma_split"`` for f32 (each
f32 operand split in the kernel into bf16 hi + lo, three products). Other
widths take ``"fma"`` (f32 sums on the CUDA cores).

For tensors on the CPU the wrapper runs the plain version
(``ref.gmm_ref``); for CUDA tensors it launches a kernel or raises.
``launches`` counts kernel launches, and only those; ``launches_by_path``
splits them by path. ``gmm`` is a ``torch.autograd.Function``: its
backward differentiates the plain version, as the reference has no
backward kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gmm_ref

#: the three kernels of csrc/moe_gmm.cu
PATHS = ("wgmma", "wgmma_split", "fma")
#: kernel launches made by ``gmm`` in this process
launches = 0
#: the same, by path
launches_by_path = dict.fromkeys(PATHS, 0)

# dtype tags of csrc/moe_gmm.cu
_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}
# tiles of each path (csrc/moe_gmm.cu): rows of C, columns of f a CTA
_TILES = {"wgmma": (128, 256), "wgmma_split": (128, 128), "fma": (128, 128)}
_GRID_MAX = 65535         # CUDA's limit on grid.y and grid.z


def kernel_path(E: int, C: int, d: int, f: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call with these shapes and dtype launches. With
    d and f multiples of 8 (TMA's 16-byte stride rule, and whole 16-byte
    units of the bf16 planes): ``"wgmma"`` for bf16, ``"wgmma_split"`` for
    f32. Else ``"fma"``. Any E and C take every path."""
    if d % 8 == 0 and f % 8 == 0:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "wgmma_split"
    return "fma"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if it starts 16-byte aligned (TMA's rule), else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gmm_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, d) @ w (E, d, f) -> (E, C, f) in x's dtype; f32 or bf16,
    one dtype, one device, contiguous. No autograd: see ``gmm``."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"gmm takes x (E, C, d) and w (E, d, f); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_TAGS or w.dtype != x.dtype:
        raise TypeError(f"gmm takes float32 or bfloat16, one dtype; got "
                        f"{x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"gmm: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gmm: x and w must be contiguous")
    dev = x.device
    if dev.type == "cpu":
        return gmm_ref(x, w)
    if dev.type != "cuda":
        raise ValueError(f"gmm runs on cuda or cpu, not {dev}")
    E, C, d = x.shape
    f = w.shape[2]
    path = kernel_path(E, C, d, f, x.dtype)
    bm, bn = _TILES[path]
    grid_y = -(-C // bm) if path == "fma" else -(-f // bn)
    if E > _GRID_MAX or grid_y > _GRID_MAX \
            or max(C * d, d * f, C * f) >= 2 ** 31:
        raise ValueError(f"gmm kernel: shape {(E, C, d, f)} past its grid "
                         f"or 32-bit index limits")
    out = torch.empty((E, C, f), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load("moe_gmm")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path != "fma":
            x, w = _aligned(x), _aligned(w)
            launch = (lib.gmm_wgmma_launch if path == "wgmma"
                      else lib.gmm_wgmma_split_launch)
            err = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, d,
                         f, stream)
        else:
            vw = 16 // x.element_size()
            vec = int(d % vw == 0 and f % vw == 0 and x.data_ptr() % 16 == 0
                      and w.data_ptr() % 16 == 0
                      and out.data_ptr() % 16 == 0)
            err = lib.gmm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 E, C, d, f, _DTYPE_TAGS[x.dtype], vec,
                                 stream)
    if err != 0:
        raise RuntimeError(f"gmm kernel ({path}) launch failed: error {err} "
                           f"for x {tuple(x.shape)}, w {tuple(w.shape)} "
                           f"{x.dtype}")
    _build.count_launch(globals(), "launches")
    _build.count_launch(launches_by_path, path)
    return out


class _Gmm(torch.autograd.Function):
    """Forward through the kernel (the plain version on the CPU); backward
    by autograd through the plain version (``torch.func.vjp``: under plain
    autograd and under ``torch.func.grad`` alike)."""

    @staticmethod
    def forward(x, w):
        return gmm_forward(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        _, vjp = torch.func.vjp(gmm_ref, *ctx.saved_tensors)
        return vjp(g)


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, d) @ w (E, d, f) -> (E, C, f) in x's dtype, differentiable."""
    return _Gmm.apply(x, w)
