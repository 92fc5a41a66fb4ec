"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf]. SWA window 4096 ⇒ bounded decode cache ⇒ long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab=32_768,
    pattern=("swa_moe",),
    window=4096,
    n_experts=8,
    top_k=2,
    d_expert=16_384,
    rope_theta=1_000_000.0,
    supports_long_context=True,
)
