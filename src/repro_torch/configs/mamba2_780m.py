"""mamba2-780m [ssm]: 48L d_model=1536, attention-free, vocab=50280.

SSD (state-space duality), d_state=128, expand=2 (d_inner=3072),
head_dim=64 (48 SSM heads).  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    arch_type="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,          # no attention heads; SSM heads live in SSMConfig
    num_kv_heads=1,
    d_ff=0,               # Mamba2 blocks have no separate MLP
    vocab_size=50280,
    head_dim=64,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
    supports_long_context=True,
    source="arXiv:2405.21060",
)
