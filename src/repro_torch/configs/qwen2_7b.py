"""Qwen2-7B — dense GQA (kv=4), QKV bias. [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab=152_064,
    pattern=("attn",),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=False,
    supports_long_context=False,
)
