"""Model configuration (``apex_tpu/models/config.py``), with
``compute_dtype``/``params_dtype`` as torch dtypes.

Only the fields the serving and training paths read carry meaning here;
the rest are kept so a configuration spells the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["TransformerConfig", "gpt_tiny", "gpt_125m", "bert_large"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Static hyperparameters of the GPT family (same fields and defaults
    as the JAX ``TransformerConfig``)."""

    num_layers: int = 2
    hidden_size: int = 128
    num_attention_heads: int = 8
    num_query_groups: Optional[int] = None
    ffn_hidden_size: Optional[int] = None
    kv_channels: Optional[int] = None
    vocab_size: int = 1024
    max_position_embeddings: int = 512

    attn_mask_type: str = "causal"
    activation: str = "gelu"            # 'gelu' | 'gelu_tanh' | 'swiglu'
    position_embedding_type: str = "learned"      # 'learned' | 'rope'
    normalization: str = "layernorm"              # 'layernorm' | 'rmsnorm'
    untie_embeddings_and_output_weights: bool = False
    layernorm_epsilon: float = 1e-5
    apply_residual_connection_post_layernorm: bool = False

    # mixture-of-experts (transformer/moe.py)
    num_experts: Optional[int] = None           # None = dense FFN
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    moe_aux_loss_coeff: float = 1e-2
    moe_ep_axis: str = "ep"                     # expert mesh axis name
    # 'capacity' = Switch drop-token einsums; 'ragged' = capacity-free
    # sort-by-expert routing through the grouped matmul (kernel row 9)
    moe_routing: str = "capacity"
    # expert-parallel dispatch wire dtype on the ragged path ('fp32' |
    # 'bf16' | 'int8'); read by the expert-parallel island only
    moe_comm: str = "fp32"

    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    drop_path_rate: float = 0.0
    init_method_std: float = 0.02

    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    softmax_in_fp32: bool = True
    attention_backend: str = "flash"

    # training: the JAX package checkpoints each layer under remat and
    # scans the stack under scan_layers; the port's decoder is a Python
    # loop either way and keeps every activation (remat is not ported)
    remat: bool = False
    scan_layers: bool = True
    # fuse the LM-head matmul into the CE loss, chunked over tokens, so
    # the [tokens, vocab] logits never exist whole (ops/lm_head_ce.py)
    fused_head_ce: bool = False
    head_ce_chunk: int = 2048

    def __post_init__(self):
        if self.ffn_hidden_size is None:
            ffn = (int(4 * self.hidden_size * 2 / 3)
                   if self.activation == "swiglu"
                   else 4 * self.hidden_size)
            object.__setattr__(self, "ffn_hidden_size", ffn)
        if self.kv_channels is None:
            if self.hidden_size % self.num_attention_heads:
                raise ValueError(
                    "num_attention_heads must divide hidden_size when "
                    "kv_channels is not given")
            object.__setattr__(self, "kv_channels",
                               self.hidden_size // self.num_attention_heads)
        if self.moe_routing not in ("capacity", "ragged"):
            raise ValueError(
                f"moe_routing ({self.moe_routing!r}) must be 'capacity' "
                "or 'ragged'")
        if self.moe_comm not in ("fp32", "bf16", "int8"):
            raise ValueError(
                f"moe_comm ({self.moe_comm!r}) must be 'fp32', 'bf16' "
                "or 'int8'")
        if self.num_query_groups is not None:
            if (self.num_query_groups < 1
                    or self.num_attention_heads % self.num_query_groups):
                raise ValueError(
                    f"num_query_groups ({self.num_query_groups}) must "
                    f"be a positive divisor of num_attention_heads "
                    f"({self.num_attention_heads})")

    @property
    def projection_size(self) -> int:
        return self.kv_channels * self.num_attention_heads

    @property
    def kv_groups(self) -> int:
        """Number of K/V heads (== num_attention_heads for MHA)."""
        return (self.num_query_groups if self.num_query_groups is not None
                else self.num_attention_heads)

    @property
    def kv_projection_size(self) -> int:
        return self.kv_channels * self.kv_groups

    @property
    def is_gqa(self) -> bool:
        """Grouped K/V: selects the group-major ``[q x rep | k | v]`` qkv
        layout (``transformer_lm.split_qkv_gqa``)."""
        return self.kv_groups != self.num_attention_heads


def gpt_tiny(**kw) -> TransformerConfig:
    """Four-layer toy GPT for tests."""
    kw.setdefault("num_layers", 4)
    kw.setdefault("hidden_size", 128)
    kw.setdefault("num_attention_heads", 8)
    kw.setdefault("vocab_size", 512)
    kw.setdefault("max_position_embeddings", 128)
    return TransformerConfig(**kw)


def gpt_125m(**kw) -> TransformerConfig:
    """GPT-2 125M: 12 layers, h=768, 12 heads, vocab 50257 padded to
    50304, 1024 learned positions."""
    kw.setdefault("num_layers", 12)
    kw.setdefault("hidden_size", 768)
    kw.setdefault("num_attention_heads", 12)
    kw.setdefault("vocab_size", 50304)
    kw.setdefault("max_position_embeddings", 1024)
    return TransformerConfig(**kw)


def bert_large(**kw) -> TransformerConfig:
    """BERT-large pretrain shape: 24 layers, h=1024, 16 heads, vocab
    30522 padded to 30592, 512 learned positions, a bidirectional
    encoder (key-padding mask, no causal triangle)."""
    kw.setdefault("num_layers", 24)
    kw.setdefault("hidden_size", 1024)
    kw.setdefault("num_attention_heads", 16)
    kw.setdefault("vocab_size", 30592)
    kw.setdefault("max_position_embeddings", 512)
    kw.setdefault("attn_mask_type", "padding")
    return TransformerConfig(**kw)
