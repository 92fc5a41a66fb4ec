"""Qwen2-0.5B — dense GQA (kv=2), QKV bias, tied embeddings. [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151_936,
    pattern=("attn",),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    supports_long_context=False,
)
