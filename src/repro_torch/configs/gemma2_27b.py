"""Gemma2-27B — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]. Pattern = (local, global) × 23; window 4096;
attn softcap 50, final softcap 30; embeddings scaled by √d and tied.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab=256_000,
    pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
    supports_long_context=False,  # global layers are full attention
)
