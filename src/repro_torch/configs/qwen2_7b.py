"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

GQA, QKV bias, SwiGLU, RoPE theta=1e6.  [arXiv:2407.10671]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mlp_type="swiglu",
    rope_theta=1e6,
    supports_long_context=False,
    source="arXiv:2407.10671",
)
