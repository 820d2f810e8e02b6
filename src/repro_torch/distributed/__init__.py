"""``repro.distributed``: the federated train steps (a shim over
``core.engine.backends.MeshBackend``, both strategies), their input specs
and the serving steps (``strategies``), and the sharding rules
(``sharding``)."""
from repro_torch.distributed.strategies import (TensorSpec, fed_batch_specs,
                                                fed_weight_specs,
                                                make_fed_train_step,
                                                make_prefill_step,
                                                make_serve_step)

__all__ = ["TensorSpec", "fed_batch_specs", "fed_weight_specs",
           "make_fed_train_step", "make_prefill_step", "make_serve_step"]
