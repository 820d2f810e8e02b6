"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT vision encoder + projector is a stub: the model takes (batch,
num_patch_tokens, d_model) anyres patch embeddings, which the language
backbone reads ahead of the text token embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    arch_type="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    mlp_type="swiglu",
    num_patch_tokens=576,     # one anyres base tile of 24x24 patches
    supports_long_context=False,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
