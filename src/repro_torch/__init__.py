"""PyTorch + CUDA port of ``repro`` (FedAvg with decaying local SGD steps).

The package mirrors ``repro``'s layout and public names; the JAX package
stays the reference it is tested against. It imports ``torch`` and numpy
only: never ``jax`` and never anything from ``repro``.

Entry points take ``device=``; the default is ``cuda`` and raises when no
CUDA device is present (see ``repro_torch.device``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
