"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan`` together with the layout work of its
adapter ``repro/kernels/ops.py::ssd_scan``: it reads the model's tensors in
place (x (B, S, H, P), b/c (B, S, N) through their batch and step strides,
so the slices of one projection that the Mamba2 block passes are not
copied, and b/c are never broadcast to the heads), masks the ragged last
chunk instead of padding, adds the D skip and stores y in x's dtype. It is
bound by operations at the mamba2-780m prefill; the source note says how the
design serves that. ``kernel_path`` picks one of its two paths before
launch, from shapes and dtype alone: ``"wgmma"`` (bf16 on the tensor cores)
or ``"fma"`` (f32 on the CUDA cores).

For tensors on the CPU the wrapper runs the plain version
(``ref.ssd_scan_ref``); for CUDA tensors it launches the kernel or raises.
``launches`` counts kernel launches (one a call: the kernel's passes go out
through one C entry point), and only those; ``launches_by_path`` splits
them by path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_scan_ref

#: the two paths of csrc/ssd_scan.cu
PATHS = ("wgmma", "fma")
#: kernel launches made by ``ssd_scan`` in this process
launches = 0
#: the same, by path
launches_by_path = dict.fromkeys(PATHS, 0)

# tags of csrc/ssd_scan.cu
_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}
_PATH_TAGS = {"fma": 0, "wgmma": 1}
MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 256, 4096
_GRID_MAX = 65535         # CUDA's limit on grid.y and grid.z


def kernel_path(B: int, S: int, H: int, P: int, N: int, Q: int,
                dtype: torch.dtype) -> str:
    """The path a CUDA call of these shapes and dtype launches: ``"wgmma"``
    for bf16 with the chunk ``Q`` a multiple of 64, ``P`` and ``N``
    multiples of 16 and at least 64 steps; ``"fma"`` for every other shape
    (f32, the reduced configs' chunk 32, S < 64). Raises for shapes no path
    takes."""
    NC = -(-S // Q) if Q > 0 else 0
    if not (1 <= P <= MAX_HEAD_DIM and 1 <= N <= MAX_STATE
            and 1 <= Q <= MAX_CHUNK) \
            or max(B * H, B * NC, NC) > _GRID_MAX:
        raise ValueError(f"ssd_scan kernel takes P <= {MAX_HEAD_DIM}, "
                         f"N <= {MAX_STATE}, chunk <= {MAX_CHUNK} and "
                         f"B*H, B*S/chunk <= {_GRID_MAX}; got (B, S, H, P, "
                         f"N) {(B, S, H, P, N)}, chunk {Q}")
    if dtype == torch.bfloat16 and Q % 64 == 0 and P % 16 == 0 \
            and N % 16 == 0 and S >= 64:
        return "wgmma"
    return "fma"


def _rows(t: torch.Tensor, inner: int, align: int) -> torch.Tensor:
    """``t`` if its last ``inner`` dims are one contiguous row and every row
    starts ``align`` bytes aligned, else a contiguous copy: the kernel takes
    any batch and step strides."""
    want = 1
    for size, stride in zip(reversed(t.shape[-inner:]),
                            reversed(t.stride()[-inner:])):
        if size > 1 and stride != want:
            return t.contiguous()
        want *= size
    es = t.element_size()
    if t.data_ptr() % align or any(
            (s * es) % align for s in t.stride()[:-inner]):
        return t.contiguous()
    return t


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, D: torch.Tensor, *,
             chunk: int):
    """x (B, S, H, P); dt (B, S, H); A (H,) negative rates; b/c (B, S, N);
    D (H,) -> (y (B, S, H, P) in x's dtype, final state (B, H, N, P) f32).

    x, b and c are float32 or bfloat16, one dtype (computed in f32); dt, A
    and D any float type, taken in f32; all on one device. No autograd: see
    ``ops.ssd_scan``."""
    if x.dim() != 4 or dt.dim() != 3 or b.dim() != 3 or c.shape != b.shape \
            or A.dim() != 1 or D.shape != A.shape:
        raise ValueError(f"ssd_scan takes x (B,S,H,P), dt (B,S,H), A (H,), "
                         f"b/c (B,S,N), D (H,); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(D.shape)}")
    B, S, H, P = x.shape
    N = b.shape[2]
    if dt.shape != (B, S, H) or b.shape[:2] != (B, S) or A.shape[0] != H:
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, b/c "
                         f"{tuple(b.shape)}, A {tuple(A.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_TAGS or b.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes x, b, c in float32 or bfloat16, "
                        f"one dtype; got {x.dtype}, {b.dtype}, {c.dtype}")
    if not all(t.is_floating_point() for t in (dt, A, D)):
        raise TypeError("ssd_scan: dt, A and D must be floating point")
    if len({t.device for t in (x, dt, A, b, c, D)}) != 1:
        raise ValueError("ssd_scan: all inputs on one device")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_ref(x, dt, A, b, c, D, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {dev}")
    path = kernel_path(B, S, H, P, N, chunk, x.dtype)
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, state
    align = 16 if path == "wgmma" else 1
    x, b, c = _rows(x, 2, align), _rows(b, 1, align), _rows(c, 1, align)
    dt, A, D = (t.to(torch.float32).contiguous() for t in (dt, A, D))
    NC = -(-S // chunk)
    cs = torch.empty((B, H, NC, chunk), dtype=torch.float32, device=dev)
    states = torch.empty((B, H, NC, N, P), dtype=torch.float32, device=dev)
    cb = torch.empty((B, NC, chunk, chunk), dtype=torch.float32, device=dev)
    sprev = (torch.empty((B, H, NC, 2, N, P), dtype=torch.bfloat16,
                         device=dev) if path == "wgmma" else None)
    dims = (ctypes.c_int64 * 6)(B, S, H, P, N, chunk)
    strides = (ctypes.c_int64 * 6)(x.stride(0), x.stride(1), b.stride(0),
                                   b.stride(1), c.stride(0), c.stride(1))
    lib = _build.load("ssd_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), b.data_ptr(),
            c.data_ptr(), D.data_ptr(), y.data_ptr(), state.data_ptr(),
            cs.data_ptr(), states.data_ptr(),
            cb.data_ptr(),
            None if sprev is None else sprev.data_ptr(),
            ctypes.addressof(dims),
            ctypes.addressof(strides), _DTYPE_TAGS[x.dtype],
            _PATH_TAGS[path], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"for x {tuple(x.shape)}, b {tuple(b.shape)}, "
                           f"chunk {chunk} {x.dtype} on path {path}")
    _build.count_launch(globals(), "launches")
    _build.count_launch(launches_by_path, path)
    return y, state
