"""Device resolution for the port's entry points.

``device=None`` means the card. Nothing falls back to the CPU silently: a
caller that wants the CPU (the tests) says so with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (the default when device=None) "
            f"but torch.cuda.is_available() is False; pass device='cpu' "
            f"to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    return dev
