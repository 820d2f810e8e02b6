"""Peak device memory of a round engine's dispatches
(``repro.core.mem``).

The reference reads the bytes each compiled executable holds (arguments,
outputs, temporaries) without running anything. PyTorch runs eagerly and
has no executables, so the port reads what the CUDA caching allocator
held: ``torch.cuda.max_memory_allocated``, the high-water mark since its
peak counter was last reset. Reset it (``torch.cuda.reset_peak_memory_stats``)
before the dispatches to measure; reading resets it again, so each reading
covers the dispatches since the one before. A streamed round of U clients
in slabs of C peaks at O(C) clients' state, a dense round at O(U).
``executable_peak_mb`` has no counterpart: there are no executables.
"""
from __future__ import annotations

import torch


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
