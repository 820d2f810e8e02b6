from repro_torch.models import (attention, layers, moe, registry, small,
                                transformer)

__all__ = ["attention", "layers", "moe", "registry", "small", "transformer"]
