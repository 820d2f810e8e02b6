"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP.  [arXiv:2402.16819]

340B params: trained with the client-sequential (Strategy B) FL simulation —
a cross-silo regime where each "client" is a cluster (see DESIGN.md §2.1).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp_type="relu2",
    norm_type="layernorm",
    supports_long_context=False,
    source="arXiv:2402.16819",
)
