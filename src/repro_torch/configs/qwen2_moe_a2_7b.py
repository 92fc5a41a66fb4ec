"""Qwen1.5/2-MoE-A2.7B — 60 routed experts top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B]. d_expert=1408; full attention (MHA kv=16).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151_936,
    pattern=("attn_moe",),
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_expert=1408,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    supports_long_context=False,
)
