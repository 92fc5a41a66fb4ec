"""Architecture registry: one module per assigned architecture.

``get_config(arch_id)`` returns the exact published ModelConfig;
``SHAPES`` defines the four assigned input-shape cells;
``cells(arch_id)`` enumerates the runnable (arch × shape) cells with the
skip rules of DESIGN.md §7 applied.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "internvl2-2b",
    "qwen1_5-0_5b",
    "gemma2-27b",
    "qwen2-7b",
    "qwen2-0_5b",
    "whisper-small",
    "recurrentgemma-9b",
    "mixtral-8x22b",
    "qwen2-moe-a2_7b",
    "rwkv6-3b",
)

# canonical ids from the brief → module names
ALIASES = {
    "internvl2-2b": "internvl2-2b",
    "qwen1.5-0.5b": "qwen1_5-0_5b",
    "gemma2-27b": "gemma2-27b",
    "qwen2-7b": "qwen2-7b",
    "qwen2-0.5b": "qwen2-0_5b",
    "whisper-small": "whisper-small",
    "recurrentgemma-9b": "recurrentgemma-9b",
    "mixtral-8x22b": "mixtral-8x22b",
    "qwen2-moe-a2.7b": "qwen2-moe-a2_7b",
    "rwkv6-3b": "rwkv6-3b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    """Why a cell is skipped (None = runnable). DESIGN.md §7."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return "full-attention KV at 500k is quadratic-prefill/unbounded-cache"
    if SHAPES[shape].step == "decode" and not cfg.has_decoder:
        return "encoder-only: no decode step"
    return None


def cells(arch: str):
    cfg = get_config(arch)
    return [
        (shape, skip_reason(cfg, shape)) for shape in SHAPES
    ]
