from repro_torch.models import attention, layers, small

__all__ = ["attention", "layers", "small"]
