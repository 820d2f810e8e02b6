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
encoder's attention is ``attention.bidirectional_attention`` and the
decoder's the plain path of ``attention.attention``. Decode writes each
layer's new k/v into the cache in place.

On the ``"model"`` ranks (``make_prefill_step(mesh=)``,
``init_cache(mesh=)``, ``make_serve_step(mesh=)``) every layer runs on a
rank's blocks (``distributed.sharding.DecodeRank``): its query heads and
the kv heads they read, its d_ff block, its vocabulary block at the
readout, the stream whole on every ``"model"`` rank and each row-parallel
partial all-reduced over them; its batch rows split over the serve batch
axes where the batch divides them. The self cache (``k``, ``v``) and the
cross cache (``cross.xk``, ``cross.xv``) are kept as this rank's blocks in
``cache_pspecs``' layout: the cross blocks computed from the encoder's
output once, and never written. On one device the same path runs with
every block whole and no collective.
"""
from __future__ import annotations

from typing import Any

import torch

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


def _one_device(batch: int = 1):
    """The ``DecodeRank`` of a model on one device (imported here: the
    ``distributed`` package imports this module)."""
    from repro_torch.distributed.sharding import DecodeRank
    return DecodeRank(None, batch)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _enc_block(bp, cfg: ArchConfig, x, tp, b):
    """One encoder layer on the ``"model"`` rank ``tp``'s blocks ``b``:
    bidirectional attention on its heads and the MLP on its d_ff block,
    each partial all-reduced over the ranks; x whole."""
    h = attention.bidirectional_attention(
        bp["attn"], cfg, layers.norm_apply(cfg.norm_type, bp["ln1"], x),
        heads=b.heads)
    x = x + tp.all_reduce(h)
    h = layers.mlp_apply(bp["mlp"],
                         layers.norm_apply(cfg.norm_type, bp["ln2"], x),
                         cfg.mlp_type, ff=b.ff)
    return x + tp.all_reduce(h)


def encode(params, cfg: ArchConfig, audio_embeds, tp=None):
    """audio_embeds: (B, S_enc, d), the stub frontend's output -> the
    encoder's states. ``tp``: the ``"model"`` rank (None: one device),
    each layer on its blocks, the states whole on every rank. Under
    autograd each layer is recomputed in the backward pass, as the
    reference's ``jax.checkpoint``."""
    tp = tp if tp is not None else _one_device()
    B, S, _ = audio_embeds.shape
    b = tp.blocks(cfg, S)
    pos = layers.sinusoidal_positions(S, cfg.d_model, audio_embeds.device)
    x = audio_embeds + pos[None].to(audio_embeds.dtype)
    for bp in tr._unbind(params["enc_stack"]):
        x = (layers.remat(_enc_block, bp, cfg, x, tp, b)
             if torch.is_grad_enabled() else _enc_block(bp, cfg, x, tp, b))
    return layers.norm_apply(cfg.norm_type, params["enc_norm"], x)


def _dec_block(bp, cfg: ArchConfig, x, positions, enc_out, tp, b):
    """One decoder layer over the whole sequence on the rank's blocks:
    causal self-attention on its heads, cross attention of its heads over
    the encoder's k, v of the kv heads they read, the MLP on its d_ff
    block; each partial all-reduced over the ranks."""
    h, _ = attention.attention(
        bp["self_attn"], cfg, layers.norm_apply(cfg.norm_type, bp["ln1"], x),
        positions, rope=False, heads=b.heads)
    x = x + tp.all_reduce(h)
    place = attention.KVPlace(enc_out.shape[1], 2, b.heads.kv)
    enc_kv = attention.cross_attention_kv(bp["cross_attn"], cfg, enc_out,
                                          place)
    h = attention.cross_attention(
        bp["cross_attn"], cfg, layers.norm_apply(cfg.norm_type, bp["ln_x"], x),
        enc_kv, heads=b.heads, place=place)
    x = x + tp.all_reduce(h)
    h = layers.mlp_apply(bp["mlp"],
                         layers.norm_apply(cfg.norm_type, bp["ln2"], x),
                         cfg.mlp_type, ff=b.ff)
    return x + tp.all_reduce(h)


def _embed(params, cfg: ArchConfig, tokens):
    """The decoder's input: token embeddings plus sinusoidal positions;
    returns (x, positions)."""
    B, S = tokens.shape
    emb = params["embed"]["embedding"]
    pos = layers.sinusoidal_positions(S, cfg.d_model, emb.device)
    x = layers.embedding_apply(params["embed"], tokens) + pos[None].to(
        emb.dtype)
    return x, _positions(B, S, x.device)


def _readout(params, cfg: ArchConfig, x, tp, b):
    """Logits of the features x on the rank's vocabulary block (the tied
    embedding's rows), all-gathered over the ranks."""
    x = layers.norm_apply(cfg.norm_type, params["final_norm"], x)
    return tp.gather(layers.embedding_attend(params["embed"], x,
                                             rows=b.vocab), 2, b.vocab_sizes)


def forward_encdec(params, cfg: ArchConfig, tokens, audio_embeds, *,
                   remat: bool = False, return_features: bool = False):
    """The full forward on one device (training, ``forward_fn``): logits
    at every position. Returns (logits | features, aux = 0)."""
    enc_out = encode(params, cfg, audio_embeds)
    x, positions = _embed(params, cfg, tokens)
    tp = _one_device()
    b = tp.blocks(cfg, x.shape[1])
    for bp in tr._unbind(params["dec_stack"]):
        if remat and torch.is_grad_enabled():
            x = layers.remat(_dec_block, bp, cfg, x, positions, enc_out, tp,
                             b)
        else:
            x = _dec_block(bp, cfg, x, positions, enc_out, tp, b)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_features:
        return x, aux
    return _readout(params, cfg, x, tp, b), aux


def prefill_encdec(params, cfg: ArchConfig, tokens, audio_embeds, tp=None):
    """The prefill of the ``"model"`` rank ``tp`` (a ``DecodeRank``; None:
    one device). ``tokens`` (B, S) and ``audio_embeds`` (B, S_enc, d) are
    whole; the rank reads its batch rows, runs the encoder and every
    decoder layer on its blocks, and the readout of the last position on
    its vocabulary block, gathered once (then the batch rows). Returns the
    last-token logits (B, V), the same on every rank."""
    n_batch = tokens.shape[0]
    tp = tp if tp is not None else _one_device(n_batch)
    rows = tp.batch_rows(n_batch)
    enc_out = encode(params, cfg, layers.block(audio_embeds, 0, rows), tp)
    x, positions = _embed(params, cfg, layers.block(tokens, 0, rows))
    b = tp.blocks(cfg, x.shape[1])
    for bp in tr._unbind(params["dec_stack"]):
        x = _dec_block(bp, cfg, x, positions, enc_out, tp, b)
    logits = _readout(params, cfg, x[:, -1:], tp, b)[:, 0]
    return tp.gather_batch(logits, 0, n_batch)


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

def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                 cross_dtype=None):
    """The decode cache's tree on the ``meta`` device: every layer's cross
    (k, v) (L, B, S_enc, KV, hd) in ``cross_dtype`` (default ``dtype``)
    and the self cache (L, B, max_seq, KV, hd)."""
    meta = torch.device("meta")
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cross = (L, batch, cfg.encoder_seq, KV, hd)
    own = (L, batch, max_seq, KV, hd)
    xd = cross_dtype if cross_dtype is not None else dtype
    return {"cross": {"xk": torch.empty(cross, dtype=xd, device=meta),
                      "xv": torch.empty(cross, dtype=xd, device=meta)},
            "k": torch.empty(own, dtype=dtype, device=meta),
            "v": torch.empty(own, dtype=dtype, device=meta)}


def _kv_place(tp, layout, b, *keys):
    """The ``KVPlace`` of the cache leaf at ``keys`` (``"k"``, or
    ``"cross", "xk"``) under ``layout`` on the rank ``tp`` (None where
    ``layout`` is: one device, the whole leaf)."""
    if layout is None:
        return None
    spec, leaf = layout.specs, layout.shapes
    for k in keys:
        spec, leaf = spec[k], leaf[k]
    return tp.kv_place(spec, leaf.shape, b)


def init_cache_encdec(params, cfg: ArchConfig, audio_embeds, max_seq: int,
                      dtype=torch.float32, mesh=None):
    """Runs the encoder once, computes every layer's cross (k, v) and
    allocates the zeroed self-attention cache (L, B, max_seq, KV, hd).

    ``mesh`` (a DeviceMesh): this rank's blocks in ``cache_pspecs``'
    layout (a ``CacheBlocks``): the encoder on the ``"model"`` ranks and
    this rank's batch rows, each layer's cross block computed straight
    from its output (``cross_attention_kv(place=)``), the self cache's
    blocks zeroed; the whole cross cache is never built. On ``meta``
    params (the dry run's accounting) the blocks' shapes, nothing run."""
    B = audio_embeds.shape[0]
    emb = params["embed"]["embedding"]
    layout = None
    if mesh is None:
        tp = _one_device(B)
    else:
        from repro_torch.distributed.sharding import CacheLayout, DecodeRank
        layout = CacheLayout(cfg, cache_shapes(cfg, B, max_seq, dtype,
                                               emb.dtype), mesh)
        if emb.device.type == "meta":
            return layout.init(emb.device)
        tp = DecodeRank(mesh, B)
    with torch.set_grad_enabled(torch.is_grad_enabled() and mesh is None):
        enc_out = encode(params, cfg,
                         layers.block(audio_embeds, 0, tp.batch_rows(B)), tp)
        place = _kv_place(tp, layout, tp.blocks(cfg, 1), "cross", "xk")
        kv = [attention.cross_attention_kv(bp["cross_attn"], cfg, enc_out,
                                           place)
              for bp in tr._unbind(params["dec_stack"])]
    cross = {"xk": torch.stack([k for k, _ in kv]),
             "xv": torch.stack([v for _, v in kv])}
    if layout is not None:
        return layout.init(enc_out.device, given={"cross": cross})
    shape = (cfg.num_layers, B, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"cross": cross,
            "k": torch.zeros(shape, dtype=dtype, device=enc_out.device),
            "v": torch.zeros(shape, dtype=dtype, device=enc_out.device)}


def decode_step_encdec(params, cfg: ArchConfig, cache, token, pos: int, *,
                       tp=None):
    """One decoder token. token: (B,); returns (logits (B, V), cache), the
    self-attention cache written in place. The position's sinusoidal phase
    is row ``pos`` of the table over the cache's length, as the
    reference.

    ``tp``: the ``"model"`` rank (``distributed.sharding.DecodeRank``;
    None: one device). The rank embeds its batch rows and runs every layer
    on its blocks over its blocks of the cache (``cache`` a
    ``CacheBlocks``): self-attention writing its block of the new slot
    (``attention_decode(heads=, place=)``), cross attention reading its
    cross blocks, the MLP on its d_ff block; then the readout on its
    vocabulary block, the logits gathered whole (and the batch rows),
    the same on every rank."""
    n_batch = token.shape[0]
    tp = tp if tp is not None else _one_device(n_batch)
    layout = getattr(cache, "layout", None) if tp.mesh is not None else None
    b = tp.blocks(cfg, 1)
    rows = layers.block(token, 0, tp.batch_rows(n_batch))
    x = layers.embedding_apply(params["embed"], rows[:, None])   # (B, 1, d)
    length = (cache if layout is None else layout.shapes)["k"].shape[2]
    full = layers.sinusoidal_positions(length, cfg.d_model, x.device)
    x = x + full[pos][None, None].to(x.dtype)
    self_place = _kv_place(tp, layout, b, "k")
    cross_place = _kv_place(tp, layout, b, "cross", "xk")
    per_layer = zip(tr._unbind(params["dec_stack"]),
                    torch.unbind(cache["k"]), torch.unbind(cache["v"]),
                    torch.unbind(cache["cross"]["xk"]),
                    torch.unbind(cache["cross"]["xv"]))
    for bp, ck, cv, xk, xv in per_layer:
        h, _, _ = attention.attention_decode(
            bp["self_attn"], cfg,
            layers.norm_apply(cfg.norm_type, bp["ln1"], x), ck, cv, pos,
            rope=False, heads=b.heads, place=self_place)
        x = x + tp.all_reduce(h)
        h = attention.cross_attention(
            bp["cross_attn"], cfg,
            layers.norm_apply(cfg.norm_type, bp["ln_x"], x), (xk, xv),
            heads=b.heads, place=cross_place)
        x = x + tp.all_reduce(h)
        h = layers.mlp_apply(bp["mlp"],
                             layers.norm_apply(cfg.norm_type, bp["ln2"], x),
                             cfg.mlp_type, ff=b.ff)
        x = x + tp.all_reduce(h)
    logits = _readout(params, cfg, x, tp, b)
    return tp.gather_batch(logits[:, 0], 0, n_batch), cache
