from repro_torch.core.serve.loop import TRAFFIC, ServingLoop

__all__ = ["ServingLoop", "TRAFFIC"]
