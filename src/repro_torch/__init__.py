"""PyTorch/CUDA port of the adaptive sketching solvers (``repro``'s solver
service: ridge, λ-path and GLM traffic), for an NVIDIA H100.

Module names mirror the JAX package: ``repro_torch.core.adaptive_padded``
answers to ``repro.core.adaptive_padded``. Nothing here imports JAX or the
JAX package; entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
