"""FedAvg server aggregation x_bar = sum_c p_c * x_c: the CUDA kernel's wrapper.

The kernel (``csrc/fedavg_reduce.cu``) replaces the Pallas TPU kernel
``repro/kernels/fedavg_reduce.py::_block_reduce``. It is bound by bytes on
a large leaf and by the latency of the client walk on a small one; the
source note says how the design serves both. One launch reduces every
leaf of a tree that shares an (input, output) dtype pair, up to
``MAX_LEAVES`` leaves: ``fedavg_reduce_stacks`` plans the launches
(``plan_launches``, once for each layout of its arguments: later calls
with the same shapes, dtypes and alignments skip the checks and the
planning), ``fedavg_reduce`` is the same kernel on a one-leaf table. Every
output is the fmaf chain over the clients in order, so all entry points
give the same bits.

``fedavg_reduce_sharded`` replaces ``fedavg_reduce_sharded`` of the same
file: each rank reduces its own client rows through the same kernel into
an f32 partial, and ``collectives.all_reduce_tiers`` (the reference's
``psum_tiers``) sums the partials across ranks, outside the kernel.

For tensors on the CPU the wrappers run the plain version
(``ref.fedavg_reduce_ref``); for CUDA tensors they launch the kernel or
raise. ``launches`` counts kernel launches, and only those;
``sharded_launches`` counts the sharded wrapper's; ``last_plans`` holds
the plans of the last call on the card.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.collectives import all_reduce_tiers
from repro_torch.kernels.ref import fedavg_reduce_ref

#: kernel launches made by ``fedavg_reduce`` and ``fedavg_reduce_stacks``
#: in this process
launches = 0
#: kernel launches made by ``fedavg_reduce_sharded`` on this rank's rows
sharded_launches = 0

# dtype tags of csrc/fedavg_reduce.cu
_DTYPE_TAGS = {torch.float32: 0, torch.bfloat16: 1}

#: threads a block; the library's own value is checked against it when it
#: loads (``kernel_layout``)
THREADS = 256
#: leaves a launch takes at most: the table in the kernel's parameters
#: (checked like ``THREADS``)
MAX_LEAVES = 64
#: blocks a leaf takes at most; its threads grid-stride over the rest
MAX_BLOCKS = 132 * 16
#: a leaf takes the 16-byte path only with a block of threads for every SM
#: at that width; a smaller leaf runs one column a thread, more threads
VEC_MIN_GROUPS = 132 * THREADS


class LeafPlan(NamedTuple):
    """One leaf's row of a launch's table."""
    index: int          # position in the caller's list of stacks
    m: int
    vec: bool           # the 16-byte path, else one column a thread
    first_block: int
    blocks: int


class LaunchPlan(NamedTuple):
    dtype: torch.dtype
    out_dtype: torch.dtype
    leaves: Tuple[LeafPlan, ...]
    blocks: int         # the grid


def plan_launches(leaves: Sequence[Tuple[int, torch.dtype, torch.dtype,
                                         int, int]]) -> List[LaunchPlan]:
    """The launches that reduce ``leaves``, each given as (M, input dtype,
    output dtype, input address, output address) of an (N, M) stack: one
    launch for each (input, output) dtype pair, in order of first
    appearance, or ceil(count / ``MAX_LEAVES``) for a larger group. A leaf
    takes the 16-byte path when both addresses are 16-byte aligned, M is a
    multiple of the 16-byte width and the leaf has ``VEC_MIN_GROUPS``
    vectors; its blocks cover one vector (or column) a thread, at most
    ``MAX_BLOCKS``, after the blocks of the leaves before it."""
    groups = {}
    for i, (_, dtype, out_dtype, _, _) in enumerate(leaves):
        groups.setdefault((dtype, out_dtype), []).append(i)
    plans = []
    for (dtype, out_dtype), index in groups.items():
        width = 16 // dtype.itemsize
        for lo in range(0, len(index), MAX_LEAVES):
            rows, first = [], 0
            for i in index[lo:lo + MAX_LEAVES]:
                m, _, _, x_addr, out_addr = leaves[i]
                vec = (m % width == 0 and x_addr % 16 == 0
                       and out_addr % 16 == 0
                       and m // width >= VEC_MIN_GROUPS)
                work = m // width if vec else m
                blocks = min(-(-work // THREADS), MAX_BLOCKS)
                rows.append(LeafPlan(i, m, vec, first, blocks))
                first += blocks
            plans.append(LaunchPlan(dtype, out_dtype, tuple(rows), first))
    return plans


# csrc ``Leaf``: x, out, m, first_block, vec (32 bytes, no padding)
_LEAF_FORMAT = "QQqii"

#: the plans of the last ``fedavg_reduce_stacks`` call on the card
last_plans: List[LaunchPlan] = []

# layout of a call's arguments -> (its plans, each with the struct that
# packs its table); checked and planned on the first call of a layout
_plan_cache: Dict[tuple, List[Tuple[LaunchPlan, struct.Struct]]] = {}
_PLAN_CACHE_SIZE = 256
_lib = None


def kernel_layout() -> Dict[str, int]:
    """The library's launch layout: threads a block, leaves a table, client
    rows a chunk on the 16-byte and on the one-column path."""
    out = (ctypes.c_int * 4)()
    _build.load("fedavg_reduce").fedavg_reduce_layout(out)
    return dict(zip(("threads", "max_leaves", "rows_vec", "rows_scalar"),
                    list(out)))


def _library():
    """The loaded library, its layout checked against the planner's."""
    global _lib
    if _lib is None:
        layout = kernel_layout()
        if (layout["threads"], layout["max_leaves"]) != (THREADS,
                                                         MAX_LEAVES):
            raise RuntimeError(f"csrc/fedavg_reduce.cu launches {layout}, "
                               f"the wrapper plans {THREADS} threads and "
                               f"{MAX_LEAVES} leaves")
        _lib = _build.load("fedavg_reduce")
    return _lib


def _check_stack(x: torch.Tensor, weights: torch.Tensor,
                 out_dtype: Optional[torch.dtype]) -> None:
    if x.dim() != 2:
        raise ValueError(f"client_stack must be (N, M), got shape "
                         f"{tuple(x.shape)}")
    n = x.shape[0]
    if weights.shape != (n,):
        raise ValueError(f"weights must be ({n},), got "
                         f"{tuple(weights.shape)}")
    if x.dtype not in _DTYPE_TAGS:
        raise TypeError(f"fedavg_reduce takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if weights.device != x.device:
        raise ValueError(f"weights on {weights.device}, client_stack on "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("client_stack must be contiguous")
    if out_dtype not in (None, x.dtype, torch.float32):
        raise TypeError(f"fedavg_reduce writes the input dtype or float32, "
                        f"not {out_dtype}")


def _check_stacks(stacks: Sequence[torch.Tensor], weights: torch.Tensor,
                  out_dtype: Optional[torch.dtype]) -> None:
    if not weights.is_floating_point():
        raise TypeError(f"weights must be floating, got {weights.dtype}")
    for x in stacks:
        _check_stack(x, weights, out_dtype)


def fedavg_reduce_stacks(stacks: Sequence[torch.Tensor],
                         weights: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> List[torch.Tensor]:
    """(N, M_i) f32/bf16 contiguous stacks, one weight vector (N,) on the
    same device -> the (M_i,) weighted sums in ``out_dtype``: each stack's
    dtype (default) or f32 (f32 accumulation either way). On CUDA: one
    launch for each plan of ``plan_launches``; each stack is read in
    place."""
    dev = weights.device
    if dev.type != "cuda":
        _check_stacks(stacks, weights, out_dtype)
        if dev.type == "cpu":
            return [fedavg_reduce_ref(x, weights, out_dtype)
                    for x in stacks]
        raise ValueError(f"fedavg_reduce runs on cuda or cpu, not {dev}")
    # everything the checks and the plan depend on, but the outputs'
    # alignment (checked below)
    x_ptrs = [x.data_ptr() for x in stacks]
    key = (weights.shape, weights.dtype, dev.index, out_dtype) + tuple(
        (x.shape, x.dtype, x.get_device(), x.is_contiguous(), p % 16)
        for x, p in zip(stacks, x_ptrs))
    cached = _plan_cache.get(key)
    if cached is None:
        _check_stacks(stacks, weights, out_dtype)
        for x in stacks:
            if x.shape[0] == 0 or x.shape[1] == 0:
                raise ValueError(f"fedavg_reduce needs N, M > 0, got "
                                 f"{tuple(x.shape)}")
    n = weights.shape[0]
    w = weights.to(torch.float32).contiguous()
    outs = [torch.empty((x.shape[1],), dtype=out_dtype or x.dtype,
                        device=dev) for x in stacks]
    out_ptrs = [o.data_ptr() for o in outs]
    if cached is None or any(p % 16 for p in out_ptrs):
        plans = plan_launches([(x.shape[1], x.dtype, o.dtype, xp, op)
                               for x, o, xp, op in zip(stacks, outs, x_ptrs,
                                                       out_ptrs)])
        cached = [(plan, struct.Struct("<" + _LEAF_FORMAT * len(plan.leaves)))
                  for plan in plans]
        if not any(p % 16 for p in out_ptrs):
            if len(_plan_cache) >= _PLAN_CACHE_SIZE:
                _plan_cache.clear()
            _plan_cache[key] = cached
    lib = _library()
    global last_plans
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for plan, table in cached:
            values = []
            for r in plan.leaves:
                values += (x_ptrs[r.index], out_ptrs[r.index], r.m,
                           r.first_block, r.vec)
            err = lib.fedavg_reduce_tree_launch(
                table.pack(*values), len(plan.leaves), w.data_ptr(), n,
                _DTYPE_TAGS[plan.dtype], _DTYPE_TAGS[plan.out_dtype],
                plan.blocks, stream)
            if err != 0:
                raise RuntimeError(
                    f"fedavg_reduce kernel launch failed: CUDA error {err} "
                    f"for {len(plan.leaves)} leaves of N={n} {plan.dtype} "
                    f"-> {plan.out_dtype}")
            _build.count_launch(globals(), "launches")
    last_plans = [plan for plan, _ in cached]
    return outs


def fedavg_reduce(client_stack: torch.Tensor, weights: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """client_stack: (N, M) f32/bf16, contiguous; weights: (N,) floating, on
    the same device -> (M,) in ``out_dtype``: the input dtype (default) or
    f32 (f32 accumulation either way). One launch on CUDA."""
    return fedavg_reduce_stacks([client_stack], weights, out_dtype)[0]


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
            _build.count_launch(globals(), "sharded_launches")
    else:
        partial = torch.zeros((m,), dtype=torch.float32,
                              device=client_rows.device)
    all_reduce_tiers(partial, mesh, client_axes, reduce_tiers)
    return partial.to(client_rows.dtype)
