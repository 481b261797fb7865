"""Frozen architecture configs as explicit dataclasses.

Replaces the reference's argparse-namespace hacks
(reference models/mm_model.py:325-377  molecule_architecture /
fds_config / crossmodal_config) with typed dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class UniMolEncoderConfig:
    """Uni-Mol-style 3D conformer encoder (reference: molecule_architecture()).

    15 layers / 512 dim / 64 heads / FFN 2048, gelu, pre-LN, gaussian pair
    kernel with K=128 features projected to one scalar bias per head.
    """

    encoder_layers: int = 15
    embed_dim: int = 512
    ffn_embed_dim: int = 2048
    attention_heads: int = 64
    dropout: float = 0.1
    emb_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    pooler_dropout: float = 0.2
    max_seq_len: int = 512
    # 'gelu_tanh': TPU-first default (VPU erf is 2x the cost, ~4ms/step at
    # flagship scale); set 'gelu' for exact reference (erf) numerics
    activation_fn: str = "gelu_tanh"
    pooler_activation_fn: str = "tanh"
    post_ln: bool = False
    kernel: str = "gaussian"
    gaussian_kernels: int = 128     # K
    delta_pair_repr_norm_loss: float = -1.0
    # rematerialize each encoder layer in the backward pass (trades ~30%
    # compute for activation memory; useful at max_atoms-scale sequences)
    remat: bool = False
    # storage dtype of the layer-threaded [B,H,N,N] pair logits; accumulation
    # stays fp32.  'bfloat16' halves the hottest HBM traffic and matches the
    # reference's fp16-AMP envelope; 'float32' for exact-oracle numerics.
    pair_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.attention_heads


@dataclasses.dataclass(frozen=True)
class ChemBertaConfig:
    """RoBERTa-style SMILES encoder (ChemBERTa).

    hidden_size must equal the cross-modal hidden size (512) so the two token
    streams concatenate (reference: models/mm_model.py:369,475).
    Defaults below describe the self-contained built-in model; loading an HF
    checkpoint overrides them from its config.json.
    """

    vocab_size: int = 600
    hidden_size: int = 512
    num_hidden_layers: int = 6
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 515  # 512 usable + pad offset 2 + 1
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 1               # RoBERTa convention


@dataclasses.dataclass(frozen=True)
class CrossModalConfig:
    """Bidirectional BERT cross-attention fusion (reference: crossmodal_config())."""

    hidden_size: int = 512
    num_attention_heads: int = 16
    intermediate_size: int = 2048
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.3
    attention_probs_dropout_prob: float = 0.2
    layer_norm_eps: float = 1e-12
    num_layers: int = 1


@dataclasses.dataclass(frozen=True)
class FDSConfig:
    """Feature Distribution Smoothing (reference: fds_config())."""

    feature_dim: int = 512
    bucket_num: int = 20
    bucket_start: int = 0
    start_update: int = 0
    start_smooth: int = 1
    kernel: str = "gaussian"
    ks: int = 5
    sigma: float = 1.0
    momentum: Optional[float] = 0.9
