"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

<name>.py  — the wrapper: checks, launch on the current stream, launch count
ops.py     — public entry points, device dispatch, tree helpers
ref.py     — plain PyTorch versions (CPU path and on-card ground truth)
_build.py  — nvcc build of ``csrc/*.cu`` at first use + ctypes loader
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
