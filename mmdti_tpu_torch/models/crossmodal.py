"""Bidirectional BERT cross-attention fusion (port of
mmdti_tpu/models/crossmodal.py).

Q from stream-1, K/V from stream-2, additive -10000 mask over stream-2 keys,
post-LN residual blocks with a GELU FFN; two such encoders run in both
directions, with dropout on both streams first when a ``generator`` is
given (models/layers.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmdti_tpu_torch.configs.architectures import CrossModalConfig
from mmdti_tpu_torch.models.layers import (
    Dense,
    FusedLN,
    draw_seed,
    dropout,
    get_activation_fn,
)
from mmdti_tpu_torch.ops.attention import masked_attention

_MASK_FILL = -10000.0


class BertCrossAttentionLayer(nn.Module):
    def __init__(self, cfg: CrossModalConfig, dtype=torch.float32, use_kernels=True):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.compute_dtype = dtype
        self.use_kernels = use_kernels
        self.act = get_activation_fn(cfg.hidden_act)
        self.query = Dense(E, E, dtype)
        self.key = Dense(E, E, dtype)
        self.value = Dense(E, E, dtype)
        self.attn_output = Dense(E, E, dtype)
        self.attn_LayerNorm = FusedLN(E, cfg.layer_norm_eps, use_kernels)
        self.intermediate = Dense(E, cfg.intermediate_size, dtype)
        self.output = Dense(cfg.intermediate_size, E, dtype)
        self.output_LayerNorm = FusedLN(E, cfg.layer_norm_eps, use_kernels)

    def forward(self, s1, s2, s2_key_mask_bias, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        ctx = masked_attention(
            self.query(s1), self.key(s2), self.value(s2), s2_key_mask_bias,
            num_heads=cfg.num_attention_heads, dropout_rate=cfg.attention_probs_dropout_prob,
            seed=draw_seed(generator, cfg.attention_probs_dropout_prob),
            deterministic=generator is None, use_kernels=self.use_kernels,
        )
        ctx = dropout(self.attn_output(ctx), cfg.hidden_dropout_prob, generator)
        attn_out = self.attn_LayerNorm(ctx + s1, out_dtype=self.compute_dtype)
        out = self.output(self.act(self.intermediate(attn_out)))
        out = dropout(out, cfg.hidden_dropout_prob, generator)
        return self.output_LayerNorm(out + attn_out, out_dtype=self.compute_dtype)


class BertCrossEncoder(nn.Module):
    def __init__(self, cfg: CrossModalConfig, dtype=torch.float32, use_kernels=True):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", BertCrossAttentionLayer(cfg, dtype, use_kernels))

    def forward(self, s1, s2, s2_key_mask_bias, generator: Optional[torch.Generator] = None):
        x = s1
        for i in range(self.cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, s2, s2_key_mask_bias, generator)
        return x


class CrossAttentionModel(nn.Module):
    """Both directions.  stream_a = 3D-graph token stream with its mask,
    stream_b = SMILES token stream with its mask.  Returns
    (a_attends_to_b [B,Na,E], b_attends_to_a [B,Nb,E])."""

    def __init__(self, cfg: CrossModalConfig, dtype=torch.float32, use_kernels=True):
        super().__init__()
        self.cfg = cfg
        self.graph_attention = BertCrossEncoder(cfg, dtype, use_kernels)
        self.text_attention = BertCrossEncoder(cfg, dtype, use_kernels)

    def forward(self, stream_a, stream_b, a_mask, b_mask,
                generator: Optional[torch.Generator] = None):
        def key_mask_bias(mask):
            return (1.0 - mask.float()) * _MASK_FILL

        stream_a = dropout(stream_a, self.cfg.hidden_dropout_prob, generator)
        stream_b = dropout(stream_b, self.cfg.hidden_dropout_prob, generator)
        # stream-b queries attend over stream-a keys (mask on a)
        b_to_a = self.graph_attention(stream_b, stream_a, key_mask_bias(a_mask), generator)
        # stream-a queries attend over stream-b keys (mask on b)
        a_to_b = self.text_attention(stream_a, stream_b, key_mask_bias(b_mask), generator)
        return a_to_b, b_to_a
