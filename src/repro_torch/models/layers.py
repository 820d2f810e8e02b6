"""Layer primitives: initialisers, dense, norms, embedding, RoPE, MLPs,
softcap (the functions of ``repro.models.layers``).

Params are nested dicts of tensors with the reference's keys and layouts
(dense ``kernel`` is (in, out)), so a reference parameter tree crosses over
through numpy with no transposes (``repro_torch.bridge``). Initialisers draw
from a ``torch.Generator`` on the CPU and then move to ``device``, so one
seed gives the same weights on every device; they do not reproduce the
reference's ``jax.random`` streams. On the ``meta`` device they draw
nothing and allocate nothing: ``registry.param_count`` counts shapes so.
Norms, RoPE and softmax-adjacent math run in f32 and cast back, as the
reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, stddev, dtype, device):
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    # scaled in place: host memory holds one copy of a (GB-sized) bank
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return w.mul_(stddev).to(device=device, dtype=dtype)


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
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def layernorm_init(dim, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm_apply(p, x, eps=1e-5):
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def norm_init(kind, dim, dtype=torch.float32, device="cpu"):
    return (layernorm_init(dim, dtype, device) if kind == "layernorm"
            else rmsnorm_init(dim, dtype, device))


def norm_apply(kind, p, x):
    return layernorm_apply(p, x) if kind == "layernorm" else rmsnorm_apply(p, x)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embedding_init(gen, vocab, dim, dtype=torch.float32, device="cpu"):
    return {"embedding": normal_init(gen, (vocab, dim), dim ** -0.5, dtype,
                                     device)}


def embedding_apply(p, ids):
    return F.embedding(ids.long(), p["embedding"])


def embedding_attend(p, x):
    """Tied-readout logits: x @ E^T."""
    return x @ p["embedding"].T


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers. The
    head splits in halves (not interleaved); angles are f32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                       # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int, device="cpu") -> torch.Tensor:
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(half, dtype=torch.float32, device=device)
                    / half)
    ang = pos * div[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model, d_ff, mlp_type, dtype=torch.float32, device="cpu"):
    if mlp_type in ("swiglu", "geglu"):
        return {
            "gate": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
            "up": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
            "down": dense_init(gen, d_ff, d_model, dtype=dtype, device=device),
        }
    # gelu / relu2: plain two-matrix MLP
    return {
        "up": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "down": dense_init(gen, d_ff, d_model, dtype=dtype, device=device),
    }


def mlp_apply(p, x, mlp_type):
    if mlp_type == "swiglu":
        h = F.silu(dense_apply(p["gate"], x)) * dense_apply(p["up"], x)
    elif mlp_type == "geglu":
        h = (F.gelu(dense_apply(p["gate"], x), approximate="tanh")
             * dense_apply(p["up"], x))
    elif mlp_type == "gelu":
        h = F.gelu(dense_apply(p["up"], x), approximate="tanh")
    elif mlp_type == "relu2":
        h = torch.square(F.relu(dense_apply(p["up"], x)))
    else:
        raise ValueError(f"unknown mlp_type {mlp_type}")
    return dense_apply(p["down"], h)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
