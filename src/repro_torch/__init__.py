"""PyTorch/CUDA port of the OptiRoute serving path.

Mirrors the layout of the JAX package (``core/``, ``kernels/``,
``cache/``, ``adaptive/``, ``serving/``, ``data/``) and imports
nothing from it.  The route-step kNN, the semantic-cache lookup and
the bandit learning step run hand-written CUDA kernels for Hopper
(``kernels/csrc``), built with ``nvcc`` on first use; on CPU tensors
each kernel wrapper runs its plain PyTorch version instead.
"""
from repro_torch.device import resolve_device, set_fp32_precision

set_fp32_precision()

__all__ = ["resolve_device", "set_fp32_precision"]
