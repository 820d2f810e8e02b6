"""Parameter trees across the two packages, through numpy.

The port keeps the reference's keys and layouts (dense ``kernel`` (in, out),
conv kernels HWIO), so no transposes are needed. This is how a test gives
both packages the same initial parameters: ``jax.random`` streams cannot be
replayed in torch.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import tree_map

PyTree = Any


def params_from_jax(tree_of_numpy: PyTree, device: DeviceLike = None) -> PyTree:
    """Nested dict of numpy arrays (the reference's params after
    ``np.asarray``) -> nested dict of tensors on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev),
                    tree_of_numpy)


def params_to_numpy(tree: PyTree) -> PyTree:
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
