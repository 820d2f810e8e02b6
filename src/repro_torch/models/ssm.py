"""Mamba2 (SSD, state-space duality) block (``repro.models.ssm``).

arXiv:2405.21060: input projection -> short depthwise causal conv on
(x, B, C) -> per-head scalar-decay SSM evaluated with the chunked SSD
algorithm (intra-chunk quadratic terms + inter-chunk state passing) ->
gated RMSNorm -> output projection. n_groups is 1: B and C are shared by
the heads.

``ssm_forward(..., use_kernel=True)`` runs the scan through
``kernels.ops.ssd_scan`` (the hand-written CUDA kernel on the card), the
same function on the same arguments as ``ssd_chunked``; the reference's
model keeps ``ssd_chunked`` there and leaves its Pallas ``ssd_scan`` to the
kernel tests (ROADMAP.md queue C).

In the tensor-parallel prefill ``ssm_forward`` runs one ``"model"`` rank's
share: its block of SSM heads; in the tensor-parallel decode
``ssm_decode_step`` does.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models import layers


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.d_inner(cfg.d_model)
    n_heads = s.n_heads(cfg.d_model)
    conv_dim = d_inner + 2 * s.d_state
    return s, d_inner, n_heads, conv_dim


def _filled(values, dtype, device):
    """A constant parameter (shape only on ``meta``)."""
    t = torch.as_tensor(values, dtype=torch.float32)
    if torch.device(device).type == "meta":
        return torch.empty(t.shape, dtype=dtype, device="meta")
    return t.to(device=device, dtype=dtype)


def ssm_init(gen, cfg: ArchConfig, dtype=torch.float32, device="cpu"):
    s, d_inner, n_heads, conv_dim = _dims(cfg)
    in_dim = 2 * d_inner + 2 * s.d_state + n_heads    # z, x, B, C, dt
    return {
        "in_proj": layers.dense_init(gen, cfg.d_model, in_dim, dtype=dtype,
                                     device=device),
        "conv_w": layers.normal_init(gen, (s.d_conv, conv_dim), 0.1, dtype,
                                     device),
        "conv_b": _filled([0.0] * conv_dim, dtype, device),
        # A in -[1, 16], as in the paper's code
        "A_log": _filled(torch.log(torch.linspace(1.0, 16.0, n_heads)), dtype,
                         device),
        "D": _filled([1.0] * n_heads, dtype, device),
        "dt_bias": _filled([math.log(math.expm1(0.01))] * n_heads, dtype,
                           device),
        "norm": layers.rmsnorm_init(d_inner, dtype, device),
        "out_proj": layers.dense_init(gen, d_inner, cfg.d_model, dtype=dtype,
                                      device=device),
    }


def _split_proj(cfg: ArchConfig, zxbcdt, heads: int):
    """z, xBC, dt_raw: views of an ``in_proj`` product over the columns
    of ``heads`` SSM heads, ``[z | x | B | C | dt]``."""
    Dr, N = heads * cfg.ssm.head_dim, cfg.ssm.d_state
    return (zxbcdt[..., :Dr], zxbcdt[..., Dr:2 * Dr + 2 * N],
            zxbcdt[..., 2 * Dr + 2 * N:])


def head_param_blocks(cfg: ArchConfig, h0: int, h1: int):
    """The blocks of the mamba leaves that SSM heads [h0, h1) read, {leaf:
    (dim from the end, [(lo, hi), ...])}: ``in_proj``'s z, x, B and C, dt
    columns (``[z | x | B | C | dt]``), the conv's x channels then all of
    B and C, the heads' entries of ``A_log``, ``D``, ``dt_bias``, the
    gated norm's scale over their channels and ``out_proj``'s rows.
    ``ssm_forward`` and ``ssm_decode_step`` cut these; the train step's
    gradients on the ranks (``sharding.ModelGrads``) read them."""
    s, d_inner, _, conv_dim = _dims(cfg)
    P, N = s.head_dim, s.d_state
    x = (h0 * P, h1 * P)
    heads = (-1, [(h0, h1)])
    conv = (-1, [x, (d_inner, conv_dim)])
    return {"in_proj": (-1, [x, (d_inner + h0 * P, d_inner + h1 * P),
                             (2 * d_inner, 2 * d_inner + 2 * N),
                             (2 * d_inner + 2 * N + h0,
                              2 * d_inner + 2 * N + h1)]),
            "conv_w": conv, "conv_b": conv, "A_log": heads, "D": heads,
            "dt_bias": heads, "norm": (-1, [x]), "out_proj": (-2, [x])}


def _causal_conv(p, xBC, cfg: ArchConfig):
    """Depthwise causal conv over the sequence, then SiLU. xBC: (B, S,
    conv_dim); the d_conv taps are unrolled, as in the reference."""
    w = p["conv_w"]                                   # (d_conv, conv_dim)
    S = xBC.shape[1]
    xp = F.pad(xBC, (0, 0, cfg.ssm.d_conv - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(cfg.ssm.d_conv):
        out = out + xp[:, i:i + S, :] * w[i]
    return F.silu(out + p["conv_b"])


#: the chunked SSD contraction, x (B, S, H, P), dt (B, S, H), A (H,), B_/C_
#: (B, S, N), D (H,) -> (y, final state (B, H, N, P)): the kernel's plain
#: version
ssd_chunked = ssd_scan_ref


def _channels(cfg: ArchConfig, t, h0: int, h1: int):
    """The xBC channels of SSM heads [h0, h1) along t's last dim: their x
    channels, then all of B and C (``t`` itself for every head)."""
    if (h0, h1) == (0, _dims(cfg)[2]):
        return t
    return torch.cat([t[..., lo:hi] for lo, hi in
                      head_param_blocks(cfg, h0, h1)["conv_w"][1]], dim=-1)


def _in_proj(p, cfg: ArchConfig, h0: int, h1: int):
    """``in_proj``'s leaf for SSM heads [h0, h1): its z, x, B and C, dt
    columns (``head_param_blocks``) side by side, in ``in_proj``'s own
    layout (the leaf itself for every head)."""
    if (h0, h1) == (0, _dims(cfg)[2]):
        return p["in_proj"]
    spans = head_param_blocks(cfg, h0, h1)["in_proj"][1]
    return {k: torch.cat([t[..., lo:hi] for lo, hi in spans], dim=-1)
            for k, t in p["in_proj"].items()}


def ssm_forward(p, cfg: ArchConfig, u, *, use_kernel: bool = False,
                heads=None, all_reduce=None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward. u: (B, S, d_model). Returns (out, {"ssm":
    final state in u's dtype, "conv": the last d_conv - 1 raw xBC rows}).

    ``heads`` (h0, h1) (None: every head) is one ``"model"`` rank's share
    in the tensor-parallel prefill: its heads' z, x and dt columns of
    ``in_proj`` with all of B and C, the depthwise conv on its channels,
    the scan on its heads, the gated RMSNorm over the whole d_inner (its
    sum of squares summed over the ranks by ``all_reduce``) and
    ``out_proj`` row-parallel. ``out`` is then the rank's partial sum,
    which the caller reduces, and the states its heads' (the conv state:
    its x channels, then B and C)."""
    s, d_inner, n_heads, conv_dim = _dims(cfg)
    h0, h1 = heads if heads is not None else (0, n_heads)
    Bsz, S, _ = u.shape
    P, N = s.head_dim, s.d_state
    Dr = (h1 - h0) * P                          # the rank's x channels
    z, xBC_raw, dt_raw = _split_proj(
        cfg, layers.dense_apply(_in_proj(p, cfg, h0, h1), u), h1 - h0)
    xBC = _causal_conv({k: _channels(cfg, p[k], h0, h1)
                        for k in ("conv_w", "conv_b")}, xBC_raw, cfg)
    f32 = torch.float32
    x = xBC[..., :Dr].reshape(Bsz, S, h1 - h0, P)
    B_ = xBC[..., Dr:Dr + N]
    C_ = xBC[..., Dr + N:]
    cut = lambda t: layers.block(t, 0, (h0, h1)).to(f32)
    dt = F.softplus(dt_raw.to(f32) + cut(p["dt_bias"]))
    A = -torch.exp(cut(p["A_log"]))
    if use_kernel:
        # x, B and C in their own dtype: the kernel reads the projection's
        # slices in place and widens bf16 to f32 exactly, so a bf16 model
        # takes the tensor-core path and computes what ssd_chunked does
        y, final_state = ops.ssd_scan(x, dt, A, B_, C_, cut(p["D"]),
                                      chunk=s.chunk_size)
    else:
        y, final_state = ssd_chunked(x.to(f32), dt, A, B_.to(f32),
                                     C_.to(f32), cut(p["D"]),
                                     chunk=s.chunk_size)
    y = y.reshape(Bsz, S, Dr).to(u.dtype)
    blk = head_param_blocks(cfg, h0, h1)
    y = layers.rmsnorm_apply(
        {"scale": layers.block(p["norm"]["scale"], 0, blk["norm"][1][0])},
        y * F.silu(z), all_reduce=all_reduce, n=d_inner)
    out = layers.dense_block(p["out_proj"], y, blk["out_proj"])
    # decode-ready states; the conv rows are copied out of the projection
    # so that the (B, S, conv_dim) tensor is freed with the layer
    state = {"ssm": final_state.to(u.dtype),
             "conv": xBC_raw[:, -(s.d_conv - 1):, :].clone()}
    return out, state


def ssm_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                   device="cpu"):
    s, d_inner, n_heads, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, n_heads, s.d_state, s.head_dim),
                           dtype=dtype, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def ssm_decode_step(p, cfg: ArchConfig, u, state, *, heads=None,
                    all_reduce=None, conv_window=None):
    """One-token recurrent step. u: (B, 1, d_model). Returns (out,
    new_state); ``state`` is not written (the model's decode copies the new
    state into its cache).

    ``heads`` (h0, h1) (None: every head) is one ``"model"`` rank's share
    in the tensor-parallel decode, as ``ssm_forward``'s: ``state`` holds
    its heads' SSM state (B, h1 - h0, N, P) and its channels' conv window
    (B, d_conv - 1, its x channels then B and C); its heads' z, x and dt
    columns of ``in_proj`` with all of B and C, the conv on its channels,
    the state update on its heads, the gated RMSNorm's sum of squares
    summed over the ranks by ``all_reduce``, ``out_proj`` row-parallel.
    ``out`` is then the rank's partial sum, and the new states its heads'
    and its channels'. ``conv_window`` (None: ``state["conv"]`` then the
    new row): a function of the raw new row (B, 1, its channels) that
    returns the whole conv window (B, d_conv, its channels), for a conv
    state kept in another layout than the rank's channels."""
    s, d_inner, n_heads, conv_dim = _dims(cfg)
    h0, h1 = heads if heads is not None else (0, n_heads)
    Bsz = u.shape[0]
    f32 = torch.float32
    P, N = s.head_dim, s.d_state
    Dr = (h1 - h0) * P                          # the rank's x channels
    z, xBC_raw, dt_raw = _split_proj(
        cfg, layers.dense_apply(_in_proj(p, cfg, h0, h1), u),
        h1 - h0)                                               # (B, 1, *)
    window = (torch.cat([state["conv"], xBC_raw], dim=1)   # (B, d_conv, c)
              if conv_window is None else conv_window(xBC_raw))
    xBC = F.silu(torch.einsum("btc,tc->bc", window,
                              _channels(cfg, p["conv_w"], h0, h1))
                 + _channels(cfg, p["conv_b"], h0, h1))
    x = xBC[:, :Dr].reshape(Bsz, h1 - h0, P)
    B_ = xBC[:, Dr:Dr + N]
    C_ = xBC[:, Dr + N:]
    cut = lambda t: layers.block(t, 0, (h0, h1)).to(f32)
    dt = F.softplus(dt_raw[:, 0].to(f32) + cut(p["dt_bias"]))
    A = -torch.exp(cut(p["A_log"]))                         # (H_r,)
    decay = torch.exp(dt * A)                               # (B, H_r)
    st = state["ssm"].to(f32)
    st = st * decay[..., None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, B_.to(f32), x.to(f32))
    y = torch.einsum("bn,bhnp->bhp", C_.to(f32), st)
    y = y + x.to(f32) * cut(p["D"])[None, :, None]
    y = y.reshape(Bsz, 1, Dr).to(u.dtype)
    blk = head_param_blocks(cfg, h0, h1)
    y = layers.rmsnorm_apply(
        {"scale": layers.block(p["norm"]["scale"], 0, blk["norm"][1][0])},
        y * F.silu(z), all_reduce=all_reduce, n=d_inner)
    out = layers.dense_block(p["out_proj"], y, blk["out_proj"])
    new_state = {"ssm": st.to(state["ssm"].dtype), "conv": window[:, 1:, :]}
    return out, new_state
