"""RecurrentGemma-9B (Griffin) — RG-LRU + local attention, 1 attn : 2 rnn.

[arXiv:2402.19427]. Pattern = (rnn, rnn, local) × 12 + remainder (rnn, rnn).
Bounded state ⇒ runs long_500k.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab=256_000,
    pattern=("rnn", "rnn", "local"),
    window=2048,
    rnn_width=4096,
    conv_width=4,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
    supports_long_context=True,
)
