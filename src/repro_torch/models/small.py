"""The paper's four benchmark models (Table 1), as functions on param dicts.

* Sent140:     binary linear classifier on 5k bag-of-words (convex).
* FEMNIST:     200-200 ReLU fully-connected DNN, 62-way softmax.
* CIFAR100:    2x [3x3 conv + 2x2 maxpool] + 512 FC + softmax.
* Shakespeare: 79->8 embedding, 2x stacked GRU(128), softmax.

Layouts are the reference's (``repro.models.small``): inputs NHWC, conv
kernels HWIO, dense kernels (in, out). The CNN permutes to NCHW/OIHW at the
convolution and back to NHWC before flattening, so the rows of ``fc`` are in
HWC order as in the reference. Plain functions of (params, inputs), so
``torch.func`` can take gradients of them and vmap them over clients.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers

PyTree = Any


# ---------------------------------------------------------------------------
# linear (Sent140)
# ---------------------------------------------------------------------------

def linear_init(gen, input_dim: int, num_classes: int, dtype=torch.float32,
                device="cpu"):
    return {"out": layers.dense_init(gen, input_dim, num_classes, bias=True,
                                     dtype=dtype, device=device)}


def linear_apply(params, x):
    return layers.dense_apply(params["out"], x)


# ---------------------------------------------------------------------------
# DNN (FEMNIST): 784 -> 200 -> 200 -> 62
# ---------------------------------------------------------------------------

def dnn_init(gen, input_dim: int, num_classes: int, hidden: int = 200,
             dtype=torch.float32, device="cpu"):
    kw = dict(bias=True, dtype=dtype, device=device)
    return {
        "fc1": layers.dense_init(gen, input_dim, hidden, **kw),
        "fc2": layers.dense_init(gen, hidden, hidden, **kw),
        "out": layers.dense_init(gen, hidden, num_classes, **kw),
    }


def dnn_apply(params, x):
    h = torch.relu(layers.dense_apply(params["fc1"], x))
    h = torch.relu(layers.dense_apply(params["fc2"], h))
    return layers.dense_apply(params["out"], h)


# ---------------------------------------------------------------------------
# CNN (CIFAR100)
# ---------------------------------------------------------------------------

def _conv_init(gen, kh, kw, cin, cout, dtype, device):
    fan_in = kh * kw * cin
    return {"kernel": layers.lecun_init(gen, (kh, kw, cin, cout), fan_in,
                                        dtype, device),
            "bias": torch.zeros((cout,), dtype=dtype, device=device)}


def _conv_pool(p, h):
    """SAME 3x3 stride-1 conv (padding 1) + ReLU + VALID 2x2 max-pool on
    NCHW activations; the HWIO kernel becomes OIHW here."""
    y = F.conv2d(h, p["kernel"].permute(3, 2, 0, 1), p["bias"], padding=1)
    return F.max_pool2d(torch.relu(y), 2)


def cnn_init(gen, input_shape: Tuple[int, int, int], num_classes: int,
             channels: Tuple[int, int] = (32, 64), hidden: int = 512,
             dtype=torch.float32, device="cpu"):
    h, w, c = input_shape
    flat = (h // 4) * (w // 4) * channels[1]
    return {
        "conv1": _conv_init(gen, 3, 3, c, channels[0], dtype, device),
        "conv2": _conv_init(gen, 3, 3, channels[0], channels[1], dtype,
                            device),
        "fc": layers.dense_init(gen, flat, hidden, bias=True, dtype=dtype,
                                device=device),
        "out": layers.dense_init(gen, hidden, num_classes, bias=True,
                                 dtype=dtype, device=device),
    }


def cnn_apply(params, x):
    """x: (B, H, W, C)."""
    h = _conv_pool(params["conv1"], x.permute(0, 3, 1, 2))
    h = _conv_pool(params["conv2"], h)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)    # NHWC flatten
    h = torch.relu(layers.dense_apply(params["fc"], h))
    return layers.dense_apply(params["out"], h)


# ---------------------------------------------------------------------------
# GRU (Shakespeare): emb 8, 2x GRU(128), per-step softmax
# ---------------------------------------------------------------------------

def _gru_cell_init(gen, in_dim, hidden, dtype, device):
    return {
        "wx": layers.normal_init(gen, (in_dim, 3 * hidden),
                                 1.0 / math.sqrt(in_dim), dtype, device),
        "wh": layers.normal_init(gen, (hidden, 3 * hidden),
                                 1.0 / math.sqrt(hidden), dtype, device),
        "b": torch.zeros((3 * hidden,), dtype=dtype, device=device),
    }


def _gru_layer(p, xs):
    """One GRU layer over a whole sequence, xs (B, S, in) -> (B, S, H).

    The reference's cell (not ``nn.GRU``): r, z = sigmoid of the first two
    thirds of x·Wx + h·Wh + b, and the candidate is
    tanh(x·Wx_n + r ⊙ (h·Wh_n) + b_n), with the bias outside the r ⊙ term.
    The input projection of every step is one matmul ahead of the loop."""
    hidden = p["wh"].shape[0]
    xw = xs @ p["wx"] + p["b"]                            # (B, S, 3H)
    h = xs.new_zeros((xs.shape[0], hidden))
    out = []
    for t in range(xs.shape[1]):
        xr, xz, xn = xw[:, t].split(hidden, dim=-1)
        hr, hz, hn = (h @ p["wh"]).split(hidden, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        out.append(h)
    return torch.stack(out, dim=1)


def gru_init(gen, vocab: int, num_classes: int, emb: int = 8,
             hidden: int = 128, dtype=torch.float32, device="cpu"):
    return {
        "embed": layers.embedding_init(gen, vocab, emb, dtype, device),
        "gru1": _gru_cell_init(gen, emb, hidden, dtype, device),
        "gru2": _gru_cell_init(gen, hidden, hidden, dtype, device),
        "out": layers.dense_init(gen, hidden, num_classes, bias=True,
                                 dtype=dtype, device=device),
    }


def gru_apply(params, tokens):
    """tokens: (B, S) int -> logits (B, S, classes) (next-char prediction).
    Layer 2 at step t reads only layer 1's h_t, so layer 1 runs over the
    whole sequence first."""
    x = layers.embedding_apply(params["embed"], tokens)   # (B, S, E)
    hs = _gru_layer(params["gru2"], _gru_layer(params["gru1"], x))
    return layers.dense_apply(params["out"], hs)


# ---------------------------------------------------------------------------
# unified task-model API (used by the FedAvg engine)
# ---------------------------------------------------------------------------

def init_task_model(gen: Union[int, torch.Generator], task_cfg,
                    dtype=torch.float32, device: DeviceLike = None) -> PyTree:
    """Random init from a ``torch.Generator`` (or an int seed) on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    kw = dict(dtype=dtype, device=device)
    m = task_cfg.model
    if m == "linear":
        return linear_init(gen, task_cfg.input_shape[0],
                           task_cfg.num_classes, **kw)
    if m == "dnn":
        return dnn_init(gen, task_cfg.input_shape[0], task_cfg.num_classes,
                        **kw)
    if m == "cnn":
        return cnn_init(gen, task_cfg.input_shape, task_cfg.num_classes,
                        **kw)
    if m == "gru":
        return gru_init(gen, task_cfg.num_classes, task_cfg.num_classes,
                        **kw)
    raise ValueError(m)


_APPLY = {"linear": linear_apply, "dnn": dnn_apply, "cnn": cnn_apply,
          "gru": gru_apply}


def task_loss(params, task_cfg, batch) -> Tuple[torch.Tensor, Dict]:
    """batch: {'x': features or tokens, 'y': int labels}. Mean
    cross-entropy as ``logsumexp - gold`` on f32 logits, as the reference
    computes it."""
    apply = _APPLY.get(task_cfg.model)
    if apply is None:
        raise ValueError(task_cfg.model)
    logits = apply(params, batch["x"]).float()
    y = batch["y"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None])[..., 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, dim=-1) == y).float())
    return loss, {"acc": acc}
