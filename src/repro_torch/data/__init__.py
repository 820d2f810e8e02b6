from repro_torch.data import partition, pipeline, synthetic
from repro_torch.data.population import PopulationView
from repro_torch.data.synthetic import (FederatedData, make_lm_clients,
                                        make_paper_task)

__all__ = ["partition", "pipeline", "synthetic", "FederatedData",
           "make_paper_task", "make_lm_clients", "PopulationView"]
