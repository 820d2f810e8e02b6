"""whisper-tiny [audio]: enc-dec, 4+4L d_model=384 6H (kv=6) d_ff=1536
vocab=51865.  [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor frontend is a stub: the model
takes precomputed (batch, 1500, 384) frame embeddings. The port implements
the encoder/decoder transformer backbone (LayerNorm + GELU, sinusoidal
positions, cross-attention), as the reference does.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,             # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    encoder_layers=4,
    encoder_seq=1500,
    tie_embeddings=True,
    supports_long_context=False,
    source="arXiv:2212.04356",
)
