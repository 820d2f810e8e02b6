"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.

QKV bias, SwiGLU MLP, RoPE.  [hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    mlp_type="swiglu",
    tie_embeddings=True,
    supports_long_context=False,
    source="hf:Qwen/Qwen1.5-0.5B",
)
