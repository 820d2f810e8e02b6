"""Layer primitives the paper models use: initialisers, dense, embedding.

Params are nested dicts of tensors with the reference's keys and layouts
(dense ``kernel`` is (in, out)), so a reference parameter tree crosses over
through numpy with no transposes (``repro_torch.bridge``). Initialisers draw
from a ``torch.Generator`` on the CPU and then move to ``device``, so one
seed gives the same weights on every device; they do not reproduce the
reference's ``jax.random`` streams.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, stddev, dtype, device):
    w = stddev * torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return w.to(device=device, dtype=dtype)


def lecun_init(gen: torch.Generator, shape, fan_in, dtype, device):
    return normal_init(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype,
                       device)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dense_init(gen, in_dim, out_dim, *, bias=False, dtype=torch.float32,
               device="cpu"):
    p = {"kernel": lecun_init(gen, (in_dim, out_dim), in_dim, dtype, device)}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense_apply(p, x):
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embedding_init(gen, vocab, dim, dtype=torch.float32, device="cpu"):
    return {"embedding": normal_init(gen, (vocab, dim), dim ** -0.5, dtype,
                                     device)}


def embedding_apply(p, ids):
    return F.embedding(ids.long(), p["embedding"])
