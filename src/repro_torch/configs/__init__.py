"""Config registry: ``get_arch('<id>')`` resolves an architecture the port
runs, by the reference's exact names (dots and dashes); module names use
underscores.

The port carries the four dense architectures, the two MoE ones and the
two SSM ones (mamba2 and the zamba2 hybrid). The reference's other two are
refused by name, with the slice of the port that brings them
(``ROADMAP.md``).
"""
from repro_torch.configs.base import (ArchConfig, FedConfig, MoEConfig,
                                      RuntimeModelConfig, ShapeConfig,
                                      SSMConfig)
from repro_torch.configs.paper_tasks import (PAPER_TASKS, PaperTaskConfig,
                                             get_paper_task)
from repro_torch.configs.shapes import SHAPES, get_shape

from repro_torch.configs import (gemma2_27b, mamba2_780m, mixtral_8x22b,
                                 nemotron_4_340b, phi3_5_moe_42b,
                                 qwen1_5_0_5b, qwen2_7b, zamba2_7b)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (qwen1_5_0_5b, qwen2_7b, gemma2_27b, nemotron_4_340b,
                   mixtral_8x22b, phi3_5_moe_42b, mamba2_780m, zamba2_7b)}

#: the reference's other architectures, and the part of the port that
#: brings each
LATER_ARCHS = {
    "whisper-tiny": "the encoder-decoder slice",
    "llava-next-34b": "the encoder-decoder slice (after whisper)",
}


def get_arch(name: str) -> ArchConfig:
    base = name[: -len("-reduced")] if name.endswith("-reduced") else name
    if base in LATER_ARCHS:
        raise ValueError(f"arch {base!r} is not ported yet: it comes with "
                         f"{LATER_ARCHS[base]}; the port runs "
                         f"{sorted(ARCHS)}")
    cfg = ARCHS[base]
    return cfg.reduced() if base != name else cfg


__all__ = ["ArchConfig", "FedConfig", "MoEConfig", "RuntimeModelConfig",
           "ShapeConfig", "SSMConfig", "ARCHS", "LATER_ARCHS", "SHAPES",
           "PAPER_TASKS", "PaperTaskConfig", "get_arch", "get_shape",
           "get_paper_task"]
