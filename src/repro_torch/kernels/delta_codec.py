"""The wire path's kernels: int8 decompress-reduce and decode-apply, top-k
scatter-add reduce and apply. Wrappers of ``csrc/delta_codec.cu``.

The kernels replace the Pallas TPU kernels of ``repro/kernels/delta_codec.py``
(``int8_decompress_reduce``, ``int8_decode_apply``,
``topk_scatter_reduce_mosaic``, ``topk_scatter_apply_mosaic``). All four are
bound by bytes; the source note gives each bound and what the design does
about it.

For tensors on the CPU each wrapper runs its plain version
(``kernels.ref``); for CUDA tensors it launches the kernel or raises.
``launches[name]`` counts kernel launches, and only those: one per call.
``topk_scatter_reduce``'s one launch is cooperative: it sums every output
in client order, a grid barrier between client rows.

The ``*_sharded`` wrappers replace the reference's client-sharded variants
(``int8_decompress_reduce_sharded``, ``int8_decode_apply_sharded``,
``topk_scatter_reduce_sharded``): each rank runs the kernels above on its
own client rows (the reduces) or its slice of the vector (decode-apply),
and a collective of ``kernels.collectives`` outside the kernel sums the
partials or gathers the slices. ``sharded_launches[name]`` counts their
launches on this rank the same way.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.collectives import (all_gather_flat,
                                             all_reduce_tiers, axes_size,
                                             client_rank)

#: kernel launches made by each wrapper in this process
launches = dict.fromkeys(("int8_decompress_reduce", "int8_decode_apply",
                          "topk_scatter_reduce", "topk_scatter_apply"), 0)
#: kernel launches made by each sharded wrapper on this rank
sharded_launches = dict.fromkeys(("int8_decompress_reduce_sharded",
                                  "int8_decode_apply_sharded",
                                  "topk_scatter_reduce_sharded"), 0)

# dtype tags of csrc/delta_codec.cu
_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}


def _check(cond: bool, msg: str, exc=ValueError) -> None:
    if not cond:
        raise exc(msg)


def _same_device(name: str, *tensors) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"for {what}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def int8_decompress_reduce(q: torch.Tensor, w_eff: torch.Tensor,
                           qr: Optional[torch.Tensor] = None,
                           wr_eff: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q (N, M) int8; w_eff (N,) f32 = weights * per-client scales -> (M,)
    f32 ``sum_c w_eff_c q_c``; with the residual plane ``qr``/``wr_eff``
    both planes reduce in one pass."""
    name = "int8_decompress_reduce"
    _check(q.dim() == 2, f"{name}: q must be (N, M), got {tuple(q.shape)}")
    n, m = q.shape
    _check(q.dtype == torch.int8, f"{name}: q must be int8, got {q.dtype}",
           TypeError)
    _check((qr is None) == (wr_eff is None),
           f"{name}: qr and wr_eff come together")
    for w in (w_eff, wr_eff):
        if w is not None:
            _check(w.shape == (n,), f"{name}: weights must be ({n},), got "
                   f"{tuple(w.shape)}")
            _check(w.dtype == torch.float32,
                   f"{name}: weights must be float32, got {w.dtype}",
                   TypeError)
    if qr is not None:
        _check(qr.shape == q.shape and qr.dtype == torch.int8,
               f"{name}: qr must be int8 of q's shape {tuple(q.shape)}")
    dev = _same_device(name, q, w_eff, qr, wr_eff)
    if dev.type == "cpu":
        return _ref.int8_decompress_reduce_ref(q, w_eff, qr, wr_eff)
    _check(n > 0 and m > 0, f"{name} needs N, M > 0, got ({n}, {m})")
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    lib = _build.load("delta_codec")
    with torch.cuda.device(dev):
        err = lib.int8_reduce_launch(q.data_ptr(), w_eff.data_ptr(), _ptr(qr),
                                     _ptr(wr_eff), out.data_ptr(), n, m,
                                     _stream(dev))
    _raise_on(err, name, f"shape ({n}, {m}), "
              f"{1 if qr is None else 2} plane(s)")
    _build.count_launch(launches, name)
    return out


def int8_decode_apply(ref: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      qr: Optional[torch.Tensor] = None,
                      rs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ref (M,) f32/bf16; q (M,) int8; s one f32 scale (a one-element
    tensor, read on the device) -> (M,) ``ref + q*s [+ qr*rs]`` in f32,
    stored in ``ref.dtype``."""
    name = "int8_decode_apply"
    _check(ref.dim() == 1, f"{name}: ref must be (M,), got "
           f"{tuple(ref.shape)}")
    _check(ref.dtype in _DTYPE_TAGS, f"{name}: ref must be float32 or "
           f"bfloat16, got {ref.dtype}", TypeError)
    _check((qr is None) == (rs is None), f"{name}: qr and rs come together")
    for plane in (q, qr):
        if plane is not None:
            _check(plane.shape == ref.shape and plane.dtype == torch.int8,
                   f"{name}: planes must be int8 of ref's shape "
                   f"{tuple(ref.shape)}")
    for sc in (s, rs):
        if sc is not None:
            _check(sc.numel() == 1 and sc.dtype == torch.float32,
                   f"{name}: scales must be one float32 value")
    dev = _same_device(name, ref, q, s, qr, rs)
    if dev.type == "cpu":
        return _ref.int8_decode_apply_ref(ref, q, s, qr, rs)
    m = ref.shape[0]
    _check(m > 0, f"{name} needs M > 0")
    out = torch.empty_like(ref)
    lib = _build.load("delta_codec")
    with torch.cuda.device(dev):
        err = lib.int8_apply_launch(ref.data_ptr(), q.data_ptr(),
                                    s.data_ptr(), _ptr(qr), _ptr(rs),
                                    out.data_ptr(), m, _DTYPE_TAGS[ref.dtype],
                                    _stream(dev))
    _raise_on(err, name, f"M={m} {ref.dtype}, "
              f"{1 if qr is None else 2} plane(s)")
    _build.count_launch(launches, name)
    return out


def _check_payload(name: str, vals: torch.Tensor, idx: torch.Tensor) -> None:
    _check(vals.shape == idx.shape, f"{name}: vals {tuple(vals.shape)} and "
           f"idx {tuple(idx.shape)} differ")
    _check(vals.dtype == torch.float32, f"{name}: vals must be float32, got "
           f"{vals.dtype}", TypeError)
    _check(idx.dtype == torch.int32, f"{name}: idx must be int32, got "
           f"{idx.dtype}", TypeError)


def topk_scatter_reduce(vals: torch.Tensor, idx: torch.Tensor,
                        weights: torch.Tensor, size: int) -> torch.Tensor:
    """vals (N, S) f32, idx (N, S) int32, weights (N,) f32 -> (M,) f32:
    ``out[idx] += w_c * v`` into zeros, client rows in order. Indices
    outside [0, size) (the -1 padding) match nothing; an empty payload
    gives zeros."""
    name = "topk_scatter_reduce"
    _check(vals.dim() == 2, f"{name}: vals must be (N, S), got "
           f"{tuple(vals.shape)}")
    _check_payload(name, vals, idx)
    n, s = vals.shape
    _check(weights.shape == (n,) and weights.dtype == torch.float32,
           f"{name}: weights must be ({n},) float32")
    size = int(size)
    _check(size >= 0, f"{name}: size must be >= 0, got {size}")
    dev = _same_device(name, vals, idx, weights)
    if dev.type == "cpu":
        return _ref.topk_scatter_reduce_ref(vals, idx, weights, size)
    if n == 0 or s == 0 or size == 0:          # nothing on the wire
        return torch.zeros((size,), dtype=torch.float32, device=dev)
    out = torch.empty((size,), dtype=torch.float32, device=dev)
    lib = _build.load("delta_codec")
    with torch.cuda.device(dev):
        err = lib.topk_reduce_launch(vals.data_ptr(), idx.data_ptr(),
                                     weights.data_ptr(), out.data_ptr(), n, s,
                                     size, _stream(dev))
    _raise_on(err, name, f"payload ({n}, {s}) into M={size}")
    _build.count_launch(launches, name)
    return out


def topk_scatter_apply(ref: torch.Tensor, vals: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """ref (M,) f32/bf16; vals (S,) f32, idx (S,) int32 -> ref with ``vals``
    added at ``idx`` in f32, stored in ``ref.dtype``. An empty payload
    gives a copy of ref."""
    name = "topk_scatter_apply"
    _check(ref.dim() == 1 and vals.dim() == 1,
           f"{name}: ref and vals must be 1-D, got {tuple(ref.shape)} and "
           f"{tuple(vals.shape)}")
    _check(ref.dtype in _DTYPE_TAGS, f"{name}: ref must be float32 or "
           f"bfloat16, got {ref.dtype}", TypeError)
    _check_payload(name, vals, idx)
    dev = _same_device(name, ref, vals, idx)
    if dev.type == "cpu":
        return _ref.topk_scatter_apply_ref(ref, vals, idx)
    m, s = ref.shape[0], vals.shape[0]
    if m == 0 or s == 0:                        # nothing on the wire
        return ref.clone()
    out = torch.empty_like(ref)
    lib = _build.load("delta_codec")
    with torch.cuda.device(dev):
        err = lib.topk_apply_launch(ref.data_ptr(), vals.data_ptr(),
                                    idx.data_ptr(), out.data_ptr(), s, m,
                                    _DTYPE_TAGS[ref.dtype], _stream(dev))
    _raise_on(err, name, f"payload ({s},) into M={m} {ref.dtype}")
    _build.count_launch(launches, name)
    return out


# ---------------------------------------------------------------------------
# client-sharded forms: this rank's rows or slice, then a collective
# ---------------------------------------------------------------------------

def int8_decompress_reduce_sharded(q: torch.Tensor, w_eff: torch.Tensor,
                                   qr: Optional[torch.Tensor] = None,
                                   wr_eff: Optional[torch.Tensor] = None, *,
                                   mesh, client_axes,
                                   reduce_tiers=None) -> torch.Tensor:
    """This rank's int8 rows q (n, M) and w_eff (n,) [and the residual
    plane] -> (M,) f32, the reduce over every rank's rows: the kernel on
    this rank's rows (zeros for none), then the partials all-reduced over
    ``client_axes`` (flat or by ``reduce_tiers``)."""
    name = "int8_decompress_reduce_sharded"
    _check(q.dim() == 2, f"{name}: q must be (n, M), got {tuple(q.shape)}")
    n, m = q.shape
    if n:
        partial = int8_decompress_reduce(q, w_eff, qr, wr_eff)
        if q.is_cuda:
            _build.count_launch(sharded_launches, name)
    else:
        partial = torch.zeros((m,), dtype=torch.float32, device=q.device)
    return all_reduce_tiers(partial, mesh, client_axes, reduce_tiers)


def int8_decode_apply_sharded(ref: torch.Tensor, q: torch.Tensor,
                              s: torch.Tensor,
                              qr: Optional[torch.Tensor] = None,
                              rs: Optional[torch.Tensor] = None, *, mesh,
                              axes) -> torch.Tensor:
    """ref (M,) and the payload, the same on every rank, with M a multiple
    of the ranks of ``axes`` -> (M,) ``ref + q*s [+ qr*rs]`` on every rank:
    each rank runs the kernel on its M/W slice (scales whole), and one
    all-gather rebuilds the vector (the reference keeps the slices where
    they are and lets GSPMD gather them as they are used)."""
    name = "int8_decode_apply_sharded"
    _check(ref.dim() == 1, f"{name}: ref must be (M,), got "
           f"{tuple(ref.shape)}")
    m, size = ref.shape[0], axes_size(mesh, axes)
    _check(m % size == 0, f"{name}: M={m} is not a multiple of the "
           f"{size} ranks of axes {tuple(axes)}")
    if m == 0:
        return ref.clone()
    lo = client_rank(mesh, axes) * (m // size)
    cut = lambda t: None if t is None else t[lo:lo + m // size]
    part = int8_decode_apply(cut(ref), cut(q), s, cut(qr), rs)
    if ref.is_cuda:
        _build.count_launch(sharded_launches, name)
    return all_gather_flat(part, mesh, axes)


def topk_scatter_reduce_sharded(vals: torch.Tensor, idx: torch.Tensor,
                                weights: torch.Tensor, size: int, *, mesh,
                                client_axes,
                                reduce_tiers=None) -> torch.Tensor:
    """This rank's payload rows vals/idx (n, S) and weights (n,) -> (M,)
    f32, the scatter-add reduce over every rank's rows: the kernel on this
    rank's rows (one launch, zeros for none), then the partials
    all-reduced over ``client_axes`` (flat or by ``reduce_tiers``)."""
    name = "topk_scatter_reduce_sharded"
    _check(vals.dim() == 2, f"{name}: vals must be (n, S), got "
           f"{tuple(vals.shape)}")
    if vals.shape[0]:
        partial = topk_scatter_reduce(vals, idx, weights, size)
        if vals.is_cuda and vals.numel() and int(size):  # it launched
            _build.count_launch(sharded_launches, name)
    else:
        partial = torch.zeros((int(size),), dtype=torch.float32,
                              device=vals.device)
    return all_reduce_tiers(partial, mesh, client_axes, reduce_tiers)
