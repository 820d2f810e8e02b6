"""Tree checkpointing with numpy + json (``repro.checkpoint.io``).

A checkpoint is a directory: ``arrays.npz`` (the tree's leaves keyed by
path) plus ``meta.json`` (round index, history, rng streams, controller
state...), written to a temporary directory beside ``path`` and renamed
into place. Paths are the reference's: dict keys and tuple or list indices
joined by ``/``, so an ``arrays.npz`` written by either package loads into
the other. ``None`` and ``()`` hold no leaves.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

PyTree = Any


class TensorSpec(NamedTuple):
    """Shape, dtype and device of a leaf: a ``like`` template leaf that
    holds no data."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, TensorSpec, np.ndarray))


def _items(tree: PyTree, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's order (dict keys sorted)."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield "/".join(prefix), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                        f"{'/'.join(prefix) or '<root>'}")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:    # numpy has no bf16: widen exactly
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, params: PyTree,
                    meta: Optional[Dict] = None) -> None:
    """Write ``params`` (a tree of tensors or arrays) and ``meta`` to the
    directory ``path``, replacing it atomically."""
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(path)) or ".")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: _to_numpy(v) for k, v in _items(params)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta or {}, f, indent=2, default=str)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _rebuild(like: PyTree, load, prefix: Tuple[str, ...] = ()) -> PyTree:
    if like is None:
        return None
    if _is_leaf(like):
        return load("/".join(prefix), like)
    if isinstance(like, dict):
        return {k: _rebuild(v, load, prefix + (str(k),))
                for k, v in like.items()}
    return type(like)(_rebuild(v, load, prefix + (str(i),))
                      for i, v in enumerate(like))


def load_checkpoint(path: str, like: PyTree) -> Tuple[PyTree, Dict]:
    """Restore into the structure of ``like``: each leaf becomes a tensor
    on the template leaf's device, in its dtype. A missing key raises
    ``KeyError``; a shape that differs from the template's raises
    ``ValueError`` naming the key."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def load(key, leaf):
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            return torch.from_numpy(arr).to(device=leaf.device,
                                            dtype=leaf.dtype)
        return _rebuild(like, load), meta
