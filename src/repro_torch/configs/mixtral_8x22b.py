"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention.  [arXiv:2401.04088]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    mlp_type="swiglu",
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2),
    supports_long_context=True,   # SWA bounds the KV cache
    source="arXiv:2401.04088",
)
