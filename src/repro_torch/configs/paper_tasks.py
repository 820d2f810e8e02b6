"""The paper's four benchmark FL tasks (Table 1) as configs.

A copy of ``repro.configs.paper_tasks``: datasets are synthetic generators
with the same shapes, client counts and non-IID structure
(``repro_torch.data.synthetic``); the runtime-model constants (model size
|x|, beta from Table 2, D/U bandwidths) are the paper's own numbers.
"""
from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import FedConfig, RuntimeModelConfig


@dataclass(frozen=True)
class PaperTaskConfig:
    name: str
    model: str                 # 'linear' | 'dnn' | 'cnn' | 'gru'
    num_classes: int
    input_shape: Tuple[int, ...]
    fed: FedConfig
    runtime: RuntimeModelConfig
    model_size_mb: float       # megabits, Table 1
    val_fraction: float = 0.2


# Table 1 + Table 2 values.
SENT140 = PaperTaskConfig(
    name="sent140",
    model="linear",
    num_classes=2,
    input_shape=(5000,),              # bag-of-words, 5k vocab
    fed=FedConfig(total_clients=21876, clients_per_round=50, rounds=10000,
                  k0=60, eta0=3.0, batch_size=8),
    runtime=RuntimeModelConfig(beta_seconds=5.2e-3),
    model_size_mb=0.32,
)

FEMNIST = PaperTaskConfig(
    name="femnist",
    model="dnn",
    num_classes=62,
    input_shape=(784,),               # 28x28 flattened greyscale
    fed=FedConfig(total_clients=3000, clients_per_round=60, rounds=10000,
                  k0=80, eta0=0.3, batch_size=32),
    runtime=RuntimeModelConfig(beta_seconds=0.017),
    model_size_mb=6.71,
)

CIFAR100 = PaperTaskConfig(
    name="cifar100",
    model="cnn",
    num_classes=100,
    input_shape=(32, 32, 3),
    fed=FedConfig(total_clients=500, clients_per_round=25, rounds=10000,
                  k0=50, eta0=0.01, batch_size=32),
    runtime=RuntimeModelConfig(beta_seconds=0.31),
    model_size_mb=40.0,
)

SHAKESPEARE = PaperTaskConfig(
    name="shakespeare",
    model="gru",
    num_classes=79,
    input_shape=(80,),                # sequence length 80
    fed=FedConfig(total_clients=660, clients_per_round=10, rounds=10000,
                  k0=80, eta0=0.1, batch_size=32),
    runtime=RuntimeModelConfig(beta_seconds=1.5),
    model_size_mb=5.21,
)

PAPER_TASKS = {t.name: t for t in (SENT140, FEMNIST, CIFAR100, SHAKESPEARE)}


def get_paper_task(name: str) -> PaperTaskConfig:
    return PAPER_TASKS[name]
