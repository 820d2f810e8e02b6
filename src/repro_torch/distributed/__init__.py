"""Serving steps of ``repro.distributed.strategies``; the mesh train steps
and sharding rules wait for the multi-device slice."""
from repro_torch.distributed.strategies import (make_prefill_step,
                                                make_serve_step)

__all__ = ["make_prefill_step", "make_serve_step"]
