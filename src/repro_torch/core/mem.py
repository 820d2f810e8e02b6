"""Peak device memory of bucket programs and of a round engine's
dispatches (``repro.core.mem``).

The reference reads the bytes each compiled executable holds (arguments,
outputs, temporaries) without running anything. PyTorch runs eagerly, so
the port reads what the CUDA caching allocator held:

  * ``executable_peak_bytes(exe)``: the allocator's peak over a bucket
    program's first run on the card, which the program records
    (``engine.round.BucketProgram``): the peak counter is reset just
    before that run. 0 on the CPU, which keeps no allocator statistics
    (the reference's 0 where the runtime gives no memory statistics).
  * ``engine_peak_mb(engine)`` keeps the reading it had before bucket
    programs existed: ``torch.cuda.max_memory_allocated``, the high-water
    mark since the peak counter was last reset, and it resets the counter,
    so each reading covers the dispatches since the one before. Reset it
    (``torch.cuda.reset_peak_memory_stats``) before the dispatches to
    measure. A program's first run resets the counter too, so a reading
    that spans one covers the time since that run began. The allocator is
    process-wide: under a packed fleet a reading covers every concurrent
    point.

A streamed round of U clients in slabs of C peaks at O(C) clients' state,
a dense round at O(U).
"""
from __future__ import annotations

import torch


def executable_peak_bytes(exe) -> int:
    """The allocator's peak over a bucket program's first run on the card;
    0 before it ran, on the CPU, or for an object that records none."""
    return int(getattr(exe, "peak_bytes", 0))


def executable_peak_mb(exe) -> float:
    return executable_peak_bytes(exe) / 1e6


def engine_peak_mb(engine) -> float:
    """The allocator's peak MB on ``engine.device`` since its peak counter
    was last reset; resets the counter. 0.0 on a CPU device, which keeps
    no allocator statistics (the reference's 0 where the runtime gives no
    memory statistics)."""
    dev = torch.device(engine.device)
    if dev.type != "cuda":
        return 0.0
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return peak / 1e6


def trainer_peak_mb(trainer) -> float:
    """``engine_peak_mb`` of a trainer's engine (an ``AsyncBufferedEngine``
    is its own)."""
    return engine_peak_mb(getattr(trainer, "engine", trainer))
