"""Transformer configuration shared by the port's models.

Counterpart of ``TransformerConfig`` and ``tiny_config`` in
``deeplearning4j_tpu/models/transformer.py``: the same fields and
defaults, as a plain dataclass (the JAX package's serde registration is
not carried over).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 30522          # BERT-base vocab
    max_len: int = 512
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dropout: float = 0.1
    type_vocab: int = 2
    eps: float = 1e-12
    dtype: str = "float32"           # params; compute may be bf16
    compute_dtype: str = "bfloat16"
    seed: int = 0
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def tiny_config(vocab=128, max_len=64, d_model=64, n_layers=2, n_heads=4,
                d_ff=128) -> TransformerConfig:
    return TransformerConfig(vocab_size=vocab, max_len=max_len,
                             d_model=d_model, n_layers=n_layers,
                             n_heads=n_heads, d_ff=d_ff,
                             compute_dtype="float32")
