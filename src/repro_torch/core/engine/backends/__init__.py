"""Execution backends: where a round's client fan-out runs. The port has
the single-device one so far."""
from repro_torch.core.engine.backends.local import make_parallel_round_core

__all__ = ["make_parallel_round_core"]
