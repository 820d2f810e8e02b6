"""Serving steps of ``repro.distributed.strategies``. The mesh train
steps' parallel strategy runs through its backend,
``core.engine.backends.MeshBackend``; ``make_fed_train_step``, the
sequential strategy and the sharding rules (``sharding.py``) are not
ported yet."""
from repro_torch.distributed.strategies import (make_prefill_step,
                                                make_serve_step)

__all__ = ["make_prefill_step", "make_serve_step"]
