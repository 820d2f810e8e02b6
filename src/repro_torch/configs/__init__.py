"""Config registry: ``get_arch('<id>')`` resolves an architecture, by the
reference's exact names (dots and dashes); module names use underscores.

The port carries all ten of the reference's architectures: four dense, two
MoE, two SSM (mamba2 and the zamba2 hybrid), the encoder-decoder
whisper-tiny and the vision-language llava-next-34b.
"""
from repro_torch.configs.base import (ArchConfig, FedConfig, MoEConfig,
                                      RuntimeModelConfig, ShapeConfig,
                                      SSMConfig)
from repro_torch.configs.paper_tasks import (PAPER_TASKS, PaperTaskConfig,
                                             get_paper_task)
from repro_torch.configs.shapes import SHAPES, get_shape

from repro_torch.configs import (gemma2_27b, llava_next_34b, mamba2_780m,
                                 mixtral_8x22b, nemotron_4_340b,
                                 phi3_5_moe_42b, qwen1_5_0_5b, qwen2_7b,
                                 whisper_tiny, zamba2_7b)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (qwen1_5_0_5b, qwen2_7b, gemma2_27b, nemotron_4_340b,
                   mixtral_8x22b, phi3_5_moe_42b, mamba2_780m, zamba2_7b,
                   whisper_tiny, llava_next_34b)}


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return ARCHS[name[: -len("-reduced")]].reduced()
    return ARCHS[name]


__all__ = ["ArchConfig", "FedConfig", "MoEConfig", "RuntimeModelConfig",
           "ShapeConfig", "SSMConfig", "ARCHS", "SHAPES",
           "PAPER_TASKS", "PaperTaskConfig", "get_arch", "get_shape",
           "get_paper_task"]
