"""The paper's primary contribution: FedAvg with decaying local SGD steps."""
from repro_torch.core import theory
from repro_torch.core.engine import (RoundEngine, RoundScheduler,
                                     get_aggregator, get_server_optimizer)
from repro_torch.core.fedavg import (FedAvgTrainer, History, ReferenceRun,
                                     make_eval_fn, make_round_fn,
                                     run_reference_rounds)
from repro_torch.core.loss_tracker import LossTracker, PlateauDetector
from repro_torch.core.mem import (engine_peak_mb, executable_peak_mb,
                                  trainer_peak_mb)
from repro_torch.core.runtime_model import RoundCost, RuntimeModel
from repro_torch.core.schedules import (DecayController, ETA_SCHEDULES,
                                        K_SCHEDULES, quantize_k,
                                        schedule_preview)

__all__ = ["theory", "FedAvgTrainer", "History", "ReferenceRun", "make_eval_fn",
           "make_round_fn", "run_reference_rounds", "RoundEngine",
           "RoundScheduler", "get_aggregator", "get_server_optimizer",
           "LossTracker", "PlateauDetector", "RoundCost", "RuntimeModel",
           "DecayController", "ETA_SCHEDULES", "K_SCHEDULES", "quantize_k",
           "schedule_preview", "engine_peak_mb", "executable_peak_mb",
           "trainer_peak_mb"]
