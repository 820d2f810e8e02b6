"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.

Local(SWA-4096)/global alternating layers, attention logit softcap 50,
final logit softcap 30, GeGLU MLP, head_dim=128.  [arXiv:2408.00118]

Long-context serving (500k) runs in a documented deviation mode where the
"global" layers' attention span is capped (see DESIGN.md §2.5).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    arch_type="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    mlp_type="geglu",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    layer_pattern=("local", "global"),
    norm_type="rmsnorm",
    tie_embeddings=True,
    supports_long_context=True,
    source="arXiv:2408.00118",
)
