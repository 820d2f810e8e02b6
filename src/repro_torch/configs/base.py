"""FedAvg and runtime-model configuration, copied from ``repro.configs.base``.

The port keeps its own copy so that it imports nothing of ``repro``; the
fields and defaults are the reference's, so one configuration means the same
run in both packages. Fields the port does not implement yet (transport,
downlink, streaming cohorts, async, non-uniform samplers) are kept so the
trainer can refuse them by name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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
