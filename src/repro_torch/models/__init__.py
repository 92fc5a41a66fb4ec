"""Architecture zoo: the ten assigned LM backbones as PyTorch modules (port
of ``repro.models``)."""

from .config import ModelConfig
from .transformer import Transformer, init_cache, init_params

__all__ = ["ModelConfig", "Transformer", "init_params", "init_cache"]
