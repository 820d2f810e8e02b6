from repro_torch.configs.base import FedConfig, RuntimeModelConfig
from repro_torch.configs.paper_tasks import (PAPER_TASKS, PaperTaskConfig,
                                             get_paper_task)

__all__ = ["FedConfig", "RuntimeModelConfig", "PAPER_TASKS",
           "PaperTaskConfig", "get_paper_task"]
