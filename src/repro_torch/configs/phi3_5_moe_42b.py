"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    mlp_type="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2),
    supports_long_context=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
