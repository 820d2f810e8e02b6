"""Whisper-style encoder-decoder transformer backbone
(``repro.models.encdec``).

The mel + conv frontend is a stub: the encoder takes precomputed frame
embeddings of shape (batch, encoder_seq, d_model). The backbone is whole:
bidirectional encoder self-attention, causal decoder self-attention,
decoder-to-encoder cross attention, LayerNorm + GELU and sinusoidal
positions on both sides (parameter-free; Whisper's decoder learns its
positions), as the reference has it.

The params keep the reference's keys (``embed``, tied; ``enc_stack`` and
``dec_stack`` stacked on a leading layer axis; ``enc_norm``,
``final_norm``), so ``bridge.params_from_jax`` carries a reference tree
across unchanged. The stacks are read with one ``torch.unbind`` a leaf
(``transformer._unbind``). No kernel runs here, as in the reference: the
encoder's attention is written inline and the decoder's goes through the
plain path of ``attention.attention``. Decode writes each layer's new k/v
into the cache in place.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tr

PyTree = Any


def _enc_block_init(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": layers.norm_init(cfg.norm_type, cfg.d_model, dtype, device),
        "attn": attention.attn_init(gen, cfg, dtype, device),
        "ln2": layers.norm_init(cfg.norm_type, cfg.d_model, dtype, device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                               dtype, device),
    }


def _dec_block_init(gen, cfg: ArchConfig, dtype, device):
    return {
        "ln1": layers.norm_init(cfg.norm_type, cfg.d_model, dtype, device),
        "self_attn": attention.attn_init(gen, cfg, dtype, device),
        "ln_x": layers.norm_init(cfg.norm_type, cfg.d_model, dtype, device),
        "cross_attn": attention.cross_attention_init(gen, cfg, dtype, device),
        "ln2": layers.norm_init(cfg.norm_type, cfg.d_model, dtype, device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type,
                               dtype, device),
    }


def init_encdec(gen, cfg: ArchConfig, dtype=torch.float32,
                device="cpu") -> PyTree:
    """The reference's parameter tree, drawn from ``gen`` (on the ``meta``
    device: shapes only)."""
    return {
        "embed": layers.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, device),
        "enc_stack": tr._stack_init(
            lambda: _enc_block_init(gen, cfg, dtype, device),
            cfg.encoder_layers),
        "enc_norm": layers.norm_init(cfg.norm_type, cfg.d_model, dtype,
                                     device),
        "dec_stack": tr._stack_init(
            lambda: _dec_block_init(gen, cfg, dtype, device), cfg.num_layers),
        "final_norm": layers.norm_init(cfg.norm_type, cfg.d_model, dtype,
                                       device),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _enc_block(bp, cfg: ArchConfig, x, positions):
    """One encoder layer: bidirectional attention (no mask, no rope)."""
    B, S, _ = x.shape
    xn = layers.norm_apply(cfg.norm_type, bp["ln1"], x)
    q, k, v = attention._project_qkv(bp["attn"], cfg, xn, positions,
                                     rope=False)
    out = attention._attend_chunk(q, k, v, None, None)
    x = x + layers.dense_apply(bp["attn"]["wo"], out.reshape(B, S, -1))
    xn = layers.norm_apply(cfg.norm_type, bp["ln2"], x)
    return x + layers.mlp_apply(bp["mlp"], xn, cfg.mlp_type)


def encode(params, cfg: ArchConfig, audio_embeds):
    """audio_embeds: (B, S_enc, d), the stub frontend's output -> the
    encoder's states. Under autograd each layer is recomputed in the
    backward pass, as the reference's ``jax.checkpoint``."""
    B, S, _ = audio_embeds.shape
    pos = layers.sinusoidal_positions(S, cfg.d_model, audio_embeds.device)
    x = audio_embeds + pos[None].to(audio_embeds.dtype)
    positions = _positions(B, S, x.device)
    for bp in tr._unbind(params["enc_stack"]):
        if torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _enc_block, bp, cfg, x, positions, use_reentrant=False)
        else:
            x = _enc_block(bp, cfg, x, positions)
    return layers.norm_apply(cfg.norm_type, params["enc_norm"], x)


def _dec_block(bp, cfg: ArchConfig, x, positions, enc_out):
    h, _ = attention.attention(
        bp["self_attn"], cfg, layers.norm_apply(cfg.norm_type, bp["ln1"], x),
        positions, rope=False)
    x = x + h
    enc_kv = attention.cross_attention_kv(bp["cross_attn"], cfg, enc_out)
    x = x + attention.cross_attention(
        bp["cross_attn"], cfg,
        layers.norm_apply(cfg.norm_type, bp["ln_x"], x), enc_kv)
    xn = layers.norm_apply(cfg.norm_type, bp["ln2"], x)
    return x + layers.mlp_apply(bp["mlp"], xn, cfg.mlp_type)


def forward_encdec(params, cfg: ArchConfig, tokens, audio_embeds, *,
                   remat: bool = False, return_features: bool = False):
    """Training / prefill forward. Returns (logits | features, aux = 0)."""
    enc_out = encode(params, cfg, audio_embeds)
    B, S = tokens.shape
    emb = params["embed"]["embedding"]
    pos = layers.sinusoidal_positions(S, cfg.d_model, emb.device)
    x = layers.embedding_apply(params["embed"], tokens) + pos[None].to(
        emb.dtype)
    positions = _positions(B, S, x.device)
    for bp in tr._unbind(params["dec_stack"]):
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                _dec_block, bp, cfg, x, positions, enc_out,
                use_reentrant=False)
        else:
            x = _dec_block(bp, cfg, x, positions, enc_out)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_features:
        return x, aux
    x = layers.norm_apply(cfg.norm_type, params["final_norm"], x)
    return layers.embedding_attend(params["embed"], x), aux


def loss_encdec(params, cfg: ArchConfig, batch, *, remat: bool = False):
    """Next-token loss over the decoder's tokens. batch: {tokens,
    audio_embeds, [mask]}. The readout and cross-entropy run in chunks of
    positions above ``transformer.LOSS_CHUNK_MIN_ELEMENTS`` (the whole f32
    (B, S, 51865) logits would not fit), as the reference's."""
    feats, aux = forward_encdec(params, cfg, batch["tokens"],
                                batch["audio_embeds"], remat=remat,
                                return_features=True)
    tokens = batch["tokens"]
    mask = batch.get("mask")
    B, S = tokens.shape
    if B * S * cfg.vocab_size >= tr.LOSS_CHUNK_MIN_ELEMENTS \
            and S > tr.LOSS_CHUNK:
        loss = tr._chunked_xent(params, cfg, feats[:, :-1], tokens[:, 1:],
                                mask[:, 1:].to(torch.float32)
                                if mask is not None else None)
    else:
        logits = tr._readout(params, cfg, feats)
        loss = tr.xent_loss(logits[:, :-1], tokens[:, 1:], mask)
    return loss, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache_encdec(params, cfg: ArchConfig, audio_embeds, max_seq: int,
                      dtype=torch.float32):
    """Runs the encoder once, computes every layer's cross (k, v) and
    allocates the zeroed self-attention cache (L, B, max_seq, KV, hd)."""
    enc_out = encode(params, cfg, audio_embeds)
    kv = [attention.cross_attention_kv(bp["cross_attn"], cfg, enc_out)
          for bp in tr._unbind(params["dec_stack"])]
    shape = (cfg.num_layers, enc_out.shape[0], max_seq, cfg.num_kv_heads,
             cfg.head_dim)
    return {"cross": {"xk": torch.stack([k for k, _ in kv]),
                      "xv": torch.stack([v for _, v in kv])},
            "k": torch.zeros(shape, dtype=dtype, device=enc_out.device),
            "v": torch.zeros(shape, dtype=dtype, device=enc_out.device)}


def decode_step_encdec(params, cfg: ArchConfig, cache, token, pos: int):
    """One decoder token. token: (B,); returns (logits (B, V), cache), the
    self-attention cache written in place. The position's sinusoidal phase
    is row ``pos`` of the table over the cache's length, as the
    reference."""
    emb = params["embed"]["embedding"]
    x = layers.embedding_apply(params["embed"], token[:, None])
    full = layers.sinusoidal_positions(cache["k"].shape[2], cfg.d_model,
                                       emb.device)
    x = x + full[pos][None, None].to(x.dtype)
    per_layer = zip(tr._unbind(params["dec_stack"]),
                    torch.unbind(cache["k"]), torch.unbind(cache["v"]),
                    torch.unbind(cache["cross"]["xk"]),
                    torch.unbind(cache["cross"]["xv"]))
    for bp, ck, cv, xk, xv in per_layer:
        h, _, _ = attention.attention_decode(
            bp["self_attn"], cfg,
            layers.norm_apply(cfg.norm_type, bp["ln1"], x), ck, cv, pos,
            rope=False)
        x = x + h
        x = x + attention.cross_attention(
            bp["cross_attn"], cfg,
            layers.norm_apply(cfg.norm_type, bp["ln_x"], x), (xk, xv))
        xn = layers.norm_apply(cfg.norm_type, bp["ln2"], x)
        x = x + layers.mlp_apply(bp["mlp"], xn, cfg.mlp_type)
    x = layers.norm_apply(cfg.norm_type, params["final_norm"], x)
    logits = layers.embedding_attend(params["embed"], x)
    return logits[:, 0], cache
