"""Layer primitives: initialisers, dense, norms, embedding, RoPE, MLPs,
softcap (the functions of ``repro.models.layers``).

Params are nested dicts of tensors with the reference's keys and layouts
(dense ``kernel`` is (in, out)), so a reference parameter tree crosses over
through numpy with no transposes (``repro_torch.bridge``). Initialisers draw
on their ``torch.Generator``'s device and then move to ``device``: a CPU
generator (what a seed makes) gives the same weights on every device, and
a CUDA generator draws a large model on the card in a fraction of the
time, other weights than a CPU one's. They do not reproduce the
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
    # on the generator's device, scaled in place: one copy of a (GB-sized)
    # bank
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
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


def block(t, dim: int, span=None):
    """``t``'s block [lo, hi) = ``span`` along ``dim``: ``t`` itself where
    ``span`` is None or the whole dim (a model on one device reads its
    leaves whole, so its ops and gradients are the plain ones)."""
    if span is None or (span[0] == 0 and span[1] == t.shape[dim]):
        return t
    return t.narrow(dim, span[0], span[1] - span[0])


def dense_apply(p, x, *, cols=None, rows=None):
    """x @ kernel (+ bias). The tensor-parallel blocks of the whole leaf,
    each (lo, hi): ``cols``, output columns [lo, hi) (column-parallel, the
    bias cut alike); ``rows``, ``x`` holds input features [lo, hi)
    (row-parallel): the result is this rank's partial sum, which the
    caller reduces over the ranks. A row-parallel leaf has no bias."""
    y = x @ block(block(p["kernel"], 1, cols), 0, rows)
    if "bias" in p:
        if rows is not None:
            raise ValueError("a row-parallel dense leaf has no bias: each "
                             "rank would add it to its partial sum")
        y = y + block(p["bias"], 0, cols)
    return y


def dense_block(p, x, blk):
    """``dense_apply`` on the block ``blk`` = (dim from the end, [(lo, hi)])
    of a layer's ``param_blocks`` table: -1, output columns; -2, the
    kernel's rows (row-parallel)."""
    dim, (span,) = blk
    return dense_apply(p, x, cols=span) if dim == -1 else \
        dense_apply(p, x, rows=span)


# ---------------------------------------------------------------------------
# recomputation
# ---------------------------------------------------------------------------

def _map_tensors(tree, fn):
    """``tree`` (dicts, lists and tuples of anything) with each tensor
    ``t`` replaced by ``fn(t)``, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


class _Remat(torch.autograd.Function):
    """``fn(*inputs)``, a tensor or a tuple of tensors, computed without
    keeping its activations; the backward runs it again under
    ``torch.func.vjp`` for its floating inputs. It runs under plain
    autograd, ``torch.func.grad`` and ``torch.func.vmap`` (its ``vmap``
    rule generated), where ``torch.utils.checkpoint`` cannot (its
    saved-tensor hooks)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *inputs):
        return fn(*inputs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn, ctx.tuple_out = inputs[0], isinstance(output, tuple)
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        live = [i for i, t in enumerate(inputs) if t.is_floating_point()]

        def fn(*floats):
            full = list(inputs)
            for i, t in zip(live, floats):
                full[i] = t
            return ctx.fn(*full)
        _, vjp = torch.func.vjp(fn, *(inputs[i] for i in live))
        out = [None] * len(inputs)
        for i, g in zip(live, vjp(grads if ctx.tuple_out else grads[0])):
            out[i] = g
        return (None, *out)


def remat(fn, *args):
    """``fn(*args)`` (a tensor or a tuple of tensors), recomputed in the
    backward instead of kept: the reference's ``jax.checkpoint``. The
    tensors in ``args`` (nested in dicts, lists and tuples) are its
    inputs; everything else in them is passed as it is. A collective in
    ``fn`` runs again in the backward, in the same order on every
    rank."""
    tensors = []
    _map_tensors(args, tensors.append)

    def run(*inputs):
        it = iter(inputs)
        return fn(*_map_tensors(args, lambda _: next(it)))
    return _Remat.apply(run, *tensors)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-6, *, all_reduce=None, n=None):
    """RMSNorm over x's last dim. With ``all_reduce``, x holds a block of
    the ``n`` normed features (``p`` the block's scale), whose sum of
    squares ``all_reduce`` sums over the ranks that hold the others."""
    x32 = x.to(torch.float32)
    if all_reduce is None:
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    else:
        var = all_reduce(torch.sum(torch.square(x32), dim=-1,
                                   keepdim=True)) / n
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


def embedding_attend(p, x, rows=None):
    """Tied-readout logits: x @ E^T; ``rows`` (lo, hi): the logits of the
    vocabulary block [lo, hi) (E's rows)."""
    return x @ block(p["embedding"], 0, rows).T


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


def mlp_param_blocks(ff=None):
    """The blocks of the MLP's leaves that the d_ff block ``ff`` (lo, hi)
    reads, {leaf: (dim from the end, [(lo, hi)])}: ``gate`` and ``up`` by
    column, ``down`` by row. ``mlp_apply`` cuts these; the train step's
    gradients on the ranks (``sharding.ModelGrads``) read them."""
    return {"gate": (-1, [ff]), "up": (-1, [ff]), "down": (-2, [ff])}


def mlp_apply(p, x, mlp_type, ff=None):
    """The MLP; ``ff`` (lo, hi): on the d_ff block [lo, hi) only,
    column-parallel up-projections and a row-parallel ``down``, returning
    this rank's partial sum, which the caller reduces over the ranks."""
    blk = mlp_param_blocks(ff)
    up = lambda name: dense_block(p[name], x, blk[name])
    if mlp_type == "swiglu":
        h = F.silu(up("gate")) * up("up")
    elif mlp_type == "geglu":
        h = F.gelu(up("gate"), approximate="tanh") * up("up")
    elif mlp_type == "gelu":
        h = F.gelu(up("up"), approximate="tanh")
    elif mlp_type == "relu2":
        h = torch.square(F.relu(up("up")))
    else:
        raise ValueError(f"unknown mlp_type {mlp_type}")
    return dense_block(p["down"], h, blk["down"])


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
