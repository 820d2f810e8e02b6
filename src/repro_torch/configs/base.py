"""Config dataclasses, copied from ``repro.configs.base``.

The port keeps its own copy so that it imports nothing of ``repro``; the
fields and defaults are the reference's, so one configuration means the same
run in both packages. Fields the port does not implement yet (streaming
cohorts, async, non-uniform samplers) are kept so the trainer can refuse
them by name. Every architecture is an ``ArchConfig`` (exact published
spec) with a ``reduced()`` variant for CPU tests (2 layers, d_model <= 128);
``ShapeConfig`` describes the assigned input shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor for dense (einsum) dispatch path
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block hyper-params."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    """Transformer-family architecture description.

    ``arch_type`` in {dense, moe, ssm, hybrid, audio, vlm}. ``layer_pattern``
    optionally gives a per-layer pattern cycled over the layers (e.g.
    local/global for gemma2); if None, all layers are the same.
    """
    name: str
    arch_type: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    # attention variants
    qkv_bias: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None     # SWA window (tokens)
    layer_pattern: Optional[Tuple[str, ...]] = None  # cycled over layers
    rope_theta: float = 10000.0
    # MLP variants: 'swiglu' | 'gelu' | 'relu2' (squared relu) | 'geglu'
    mlp_type: str = "swiglu"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # enc-dec (audio)
    encoder_layers: int = 0
    encoder_seq: int = 0                     # stub frontend output length
    # vlm
    num_patch_tokens: int = 0                # stub vision tokens per sample
    norm_type: str = "rmsnorm"               # 'rmsnorm' | 'layernorm'
    tie_embeddings: bool = False
    supports_long_context: bool = False
    source: str = ""                         # citation

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    @property
    def layer_types(self) -> Tuple[str, ...]:
        if self.layer_pattern is None:
            base = ("mamba",) if self.arch_type == "ssm" else ("attn",)
            return tuple(base * self.num_layers)[: self.num_layers]
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU tests."""
        d_model = min(self.d_model, 128)
        num_heads = min(self.num_heads, 4)
        head_dim = max(d_model // num_heads, 16)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        # keep GQA ratio flavour: if original had kv<heads, use kv=heads//2
        if self.num_kv_heads < self.num_heads:
            num_kv = max(1, num_heads // 2)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe,
                                      num_experts=min(4, self.moe.num_experts),
                                      top_k=min(2, self.moe.top_k))
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=32,
                                      chunk_size=32)
        pattern = self.layer_pattern
        if pattern is not None:
            pattern = tuple(pattern[:2]) if len(pattern) >= 2 else pattern
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 4 * d_model) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else None),
            layer_pattern=pattern,
            moe=moe,
            ssm=ssm,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            num_patch_tokens=(min(self.num_patch_tokens, 16)
                              if self.num_patch_tokens else 0),
        )

    # -- parameter counting (the runtime model's |x| in Eq. 3) ------------
    def param_count(self) -> int:
        from repro_torch.models import registry
        return registry.param_count(self)

    def model_size_megabits(self, bytes_per_param: int = 4) -> float:
        return self.param_count() * bytes_per_param * 8 / 1e6


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


@dataclass(frozen=True)
class FedConfig:
    """FedAvg algorithm + schedule configuration (the paper's knobs)."""
    total_clients: int = 100
    clients_per_round: int = 16
    rounds: int = 100
    k0: int = 16                      # K_0 — initial local steps
    eta0: float = 0.1                 # η_0 — client learning rate
    batch_size: int = 32
    k_schedule: str = "fixed"         # fixed|rounds|error|step|cosine
    eta_schedule: str = "fixed"       # fixed|rounds|error|step
    loss_window: int = 100            # s in Eq. 15
    plateau_patience: int = 50        # rounds of no val improvement => step decay
    step_decay_factor: float = 10.0   # K0/10 per the paper
    k_min: int = 1
    k_quantize: bool = False          # quantize K to a geometric grid
    k_grid0: Optional[int] = None     # explicit quantize_k grid anchor (None = k0)
    server_optimizer: str = "avg"     # avg | fedadam | fedavgm | fedyogi
    server_lr: float = 1.0
    seed: int = 0
    strategy: str = "parallel"        # parallel (vmap) | sequential (scan)
    aggregator: str = "mean"          # mean | kernel | median | trimmed_mean
    trim_fraction: float = 0.1        # for aggregator="trimmed_mean"
    transport: str = "none"           # none | int8 | int8x2 | topk
    topk_frac: float = 0.1            # kept fraction for transport="topk"
    downlink: str = "none"            # server broadcast codec
    downlink_ref: str = "f32"         # server-held ref/residual store
    sampler: str = "uniform"          # uniform | weighted | fixed_cohort
                                      # | availability | population
    cohort: Optional[Tuple[int, ...]] = None
    availability: float = 0.9
    population: int = 0
    day_rounds: int = 24
    base_availability: float = 0.05
    bucket_rounds: int = 8            # max rounds per K-bucket
    feedback_bucket_rounds: int = 1   # bucket length for error/step schedules
    prefetch: bool = True             # build round r+1 on a background thread
    cohort_chunk: Optional[int] = None
    aggregation: str = "sync"         # sync | async
    buffer_size: Optional[int] = None
    staleness_weight: str = "constant"
    max_staleness: Optional[int] = None


@dataclass(frozen=True)
class RuntimeModelConfig:
    """Paper §3.2 / §4.2 constants (Eq. 3-5)."""
    download_mbps: float = 20.0   # D, 4G LTE UK
    upload_mbps: float = 5.0      # U
    beta_seconds: float = 0.1     # per-minibatch client compute time
    bytes_per_param: int = 4
