"""Whisper-small — enc-dec, conv frontend stubbed. [arXiv:2212.04356].

Backbone only: ``input_specs`` provides precomputed frame embeddings
(B, 1500, 768) for the encoder; decoder uses learned positions.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51_865,
    pattern=("dec",),
    n_enc_layers=12,
    enc_seq=1500,
    pos_embedding="learned",
    mlp_act="gelu",
    tie_embeddings=True,
    supports_long_context=False,
)
