from repro_torch.models import layers, small

__all__ = ["layers", "small"]
