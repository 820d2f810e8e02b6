from repro_torch.models import attention, layers, registry, small, transformer

__all__ = ["attention", "layers", "registry", "small", "transformer"]
