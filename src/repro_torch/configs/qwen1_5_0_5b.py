"""Qwen1.5-0.5B — dense, QKV bias, MHA (kv=16). [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab=151_936,
    pattern=("attn",),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    supports_long_context=False,
)
