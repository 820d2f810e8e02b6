"""Layered FedAvg round engine.

    ClientUpdate -> Aggregator -> ServerOptimizer      (one round)
    RoundScheduler -> K-buckets -> RoundEngine         (many rounds)
    BatchPrefetcher                                    (host/device overlap)
"""
from repro_torch.core.engine.aggregators import (AGGREGATORS, get_aggregator,
                                                 weighted_mean)
from repro_torch.core.engine.client import (ClientResult, client_update,
                                            make_client_update)
from repro_torch.core.engine.round import RoundEngine, make_round_fn
from repro_torch.core.engine.sampling import (
    SAMPLERS, AvailabilitySampler, ClientSampler, FixedCohortSampler,
    PopulationSampler, UniformSampler, WeightedSampler, get_sampler,
    make_sampler)
from repro_torch.core.engine.scheduler import (Bucket, RoundScheduler,
                                               is_loss_free)
from repro_torch.core.engine.server import (SERVER_OPTIMIZERS,
                                            ServerOptimizer,
                                            get_server_optimizer)
from repro_torch.core.engine.trainer import FedAvgTrainer, History, make_eval_fn

__all__ = ["AGGREGATORS", "get_aggregator", "weighted_mean", "ClientResult",
           "client_update", "make_client_update", "RoundEngine",
           "make_round_fn", "SAMPLERS", "ClientSampler",
           "UniformSampler", "WeightedSampler", "FixedCohortSampler",
           "AvailabilitySampler", "PopulationSampler", "get_sampler",
           "make_sampler", "Bucket", "RoundScheduler",
           "is_loss_free", "SERVER_OPTIMIZERS", "ServerOptimizer",
           "get_server_optimizer", "FedAvgTrainer", "History",
           "make_eval_fn"]
