from repro_torch.core.serve.loop import ServingLoop

__all__ = ["ServingLoop"]
