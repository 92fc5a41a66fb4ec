"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay.

[arXiv:2404.05892; hf]. 32 layers, d_model 2560, 40 heads of 64.
Constant-size state ⇒ long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,          # unused by rwkv kind (kept for bookkeeping)
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65_536,
    pattern=("rwkv",),
    rwkv_head_dim=64,
    rwkv_lora_r=64,
    tie_embeddings=False,
    supports_long_context=True,
)
