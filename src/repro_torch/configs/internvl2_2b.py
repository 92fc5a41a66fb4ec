"""InternVL2-2B — InternViT frontend (stub) + InternLM2-1.8B LM backbone.

[arXiv:2404.16821; hf]. Backbone only per the brief; the vision frontend is
a stub supplying precomputed patch embeddings (``input_specs``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92_553,
    pattern=("attn",),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    supports_long_context=False,
)
