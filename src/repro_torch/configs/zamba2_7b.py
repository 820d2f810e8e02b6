"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (kv=32, MHA in the shared attn block) d_ff=14336
vocab=32000, ssm_state=64.  [arXiv:2411.15242]

Zamba2 interleaves a (shared-weight) full-attention block roughly every 6
Mamba2 blocks, encoded as a repeating layer pattern: every ``attn``
position runs the one block in ``params["shared"]`` and keeps its own KV
cache.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    mlp_type="swiglu",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=256),
    layer_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "attn"),
    supports_long_context=True,
    source="arXiv:2411.15242",
)
