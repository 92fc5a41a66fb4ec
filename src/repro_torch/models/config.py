"""Model configuration for the assigned architecture zoo.

One ``ModelConfig`` describes any of the 10 assigned LM-family backbones.
Layer heterogeneity (gemma2 local/global alternation, recurrentgemma's
2-recurrent:1-attention pattern, …) is expressed as a repeating ``pattern``
of layer *kinds*. A copy of ``repro.models.config``, values unchanged.

Layer order: ``layer_kinds()`` lists the layers interleaved (pattern ×
n_blocks, then the remainder), and ``param_count`` sums over it, but
``Transformer.forward`` runs them position-major, as the reference's
``forward`` does: all ``n_blocks`` layers of pattern position 0, then all of
position 1, …, then the remainder (gemma2: local × 23, then global × 23).
Weights loaded into this stack must follow that order.

Layer kinds:
  "attn"      full causal GQA attention + dense MLP
  "local"     sliding-window causal attention + dense MLP
  "swa_moe"   sliding-window attention + MoE MLP         (mixtral)
  "attn_moe"  full attention + MoE MLP (+ shared experts) (qwen2-moe)
  "rnn"       Griffin/RecurrentGemma RG-LRU recurrent block + dense MLP
  "rwkv"      RWKV-6 time-mix + channel-mix block
  "enc"       bidirectional attention + dense MLP (whisper encoder)
  "dec"       causal self-attn + cross-attn + dense MLP (whisper decoder)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

ATTN_KINDS = ("attn", "local", "swa_moe", "attn_moe", "enc", "dec")
MOE_KINDS = ("swa_moe", "attn_moe")
WINDOWED_KINDS = ("local", "swa_moe")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = ("attn",)

    # attention
    rope_theta: float = 10_000.0
    window: int = 4096           # for windowed kinds
    attn_softcap: float = 0.0    # 0 = off (gemma2: 50)
    final_softcap: float = 0.0   # 0 = off (gemma2: 30)
    qkv_bias: bool = False
    pos_embedding: str = "rope"  # "rope" | "learned" (whisper)

    # embeddings / head
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma family scales embeds by √d_model
    onehot_embed: bool = False   # lookup as one-hot matmul: SPMD-friendly
                                 # when the table is vocab-sharded (§Perf)
    seq_shard_attn: bool = False # sequence-parallel attention over 'model'
                                 # for archs whose heads don't divide the TP
                                 # axis (q seq-sharded, kv replicated; §Perf)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0            # per-expert hidden size (= d_ff if 0)
    capacity_factor: float = 1.25

    # recurrent (Griffin RG-LRU)
    rnn_width: int = 0           # 0 → d_model
    conv_width: int = 4

    # rwkv
    rwkv_head_dim: int = 64
    rwkv_lora_r: int = 64        # rank of the data-dependent decay/mix LoRAs

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500          # whisper: 30 s of audio → 1500 frames

    # mlp / norm
    mlp_act: str = "swiglu"      # "swiglu" | "gelu"
    norm_eps: float = 1e-6

    # long-context capability: archs whose decode state is bounded
    # (recurrent state or windowed cache) can run the long_500k shape.
    supports_long_context: bool = False
    # encoder-only models have no decode step (none assigned, all have one)
    has_decoder: bool = True

    # ------------------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def n_rem(self) -> int:
        return self.n_layers % len(self.pattern)

    @property
    def d_expert_eff(self) -> int:
        return self.d_expert or self.d_ff

    @property
    def rnn_width_eff(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def param_count(self) -> int:
        """Total parameters (for MODEL_FLOPS and memory estimates)."""
        return sum(_kind_params(self, k) for k in self.layer_kinds()) + (
            self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
            + self.d_model  # final norm
        )

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        total = 0
        for k in self.layer_kinds():
            if k in MOE_KINDS:
                attn = _attn_params(self)
                ffn1 = 3 * self.d_model * self.d_expert_eff
                total += attn + ffn1 * (self.top_k + self.n_shared_experts)
                total += self.d_model * self.n_experts  # router
                total += 2 * self.d_model
            else:
                total += _kind_params(self, k)
        total += self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        total += self.d_model
        return total

    def layer_kinds(self) -> Tuple[str, ...]:
        """The full depth-ordered list of layer kinds (decoder side)."""
        return self.pattern * self.n_blocks + self.pattern[: self.n_rem]

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = self.pattern
        n_layers = max(len(pat) * 2, 2)
        heads = max(2, min(4, self.n_heads))
        kv = max(1, min(self.n_kv_heads, heads))
        hd = 16
        d_model = heads * hd
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=4 * d_model,
            vocab=512,
            window=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            d_expert=2 * d_model if self.d_expert else 0,
            rnn_width=d_model if self.rnn_width else 0,
            rwkv_head_dim=16,
            rwkv_lora_r=8,
            n_enc_layers=2 if self.n_enc_layers else 0,
            enc_seq=16 if self.n_enc_layers else self.enc_seq,
        )


def _attn_params(cfg: ModelConfig) -> int:
    q = cfg.d_model * cfg.n_heads * cfg.head_dim
    kv = 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
    o = cfg.n_heads * cfg.head_dim * cfg.d_model
    return q + kv + o


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.mlp_act == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _kind_params(cfg: ModelConfig, kind: str) -> int:
    d = cfg.d_model
    norms = 2 * d
    if kind in ("attn", "local", "enc"):
        return _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + norms
    if kind == "dec":
        return 2 * _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + 3 * d
    if kind in MOE_KINDS:
        ffn_all = 3 * d * cfg.d_expert_eff * (cfg.n_experts + cfg.n_shared_experts)
        return _attn_params(cfg) + ffn_all + d * cfg.n_experts + norms
    if kind == "rnn":
        w = cfg.rnn_width_eff
        nh = 16 if w % 16 == 0 else 1
        # in/gate projections, conv, block-diag RG-LRU gates, decay, out
        rec = 2 * d * w + cfg.conv_width * w + 2 * w * (w // nh) + w * d + w
        return rec + _mlp_params(cfg, cfg.d_ff) + norms
    if kind == "rwkv":
        r = cfg.rwkv_lora_r
        tm = 4 * d * d + d * d  # r,k,v,g,o  (w is per-channel via lora)
        loras = 5 * (d * r + r * d) + d * r * 2  # mix loras + decay lora
        cm = 2 * d * cfg.d_ff  # channel-mix (k, v) — rwkv6 uses ~3.5x
        return tm + loras + cm + norms
    raise ValueError(kind)
