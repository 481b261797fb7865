"""ChemBERTa: RoBERTa-style SMILES transformer (port of
mmdti_tpu/models/chemberta.py).

RoBERTa position ids offset from the pad token, post-LN BERT blocks, fp32
LayerNorm and softmax, and the HF additive mask (1 - mask) * finfo(fp32).min
over keys.  With a ``generator`` the forward applies the hidden and
attention-probability dropouts of the JAX model (models/layers.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmdti_tpu_torch.configs.architectures import ChemBertaConfig
from mmdti_tpu_torch.models.layers import (
    Dense,
    Embed,
    FusedLN,
    draw_seed,
    dropout,
    get_activation_fn,
)
from mmdti_tpu_torch.ops.attention import masked_attention


def roberta_position_ids(input_ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """HF create_position_ids_from_input_ids: cumulative count of non-pad
    tokens, offset by padding_idx; pads keep padding_idx."""
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class RobertaEmbeddings(nn.Module):
    def __init__(self, cfg: ChemBertaConfig, dtype=torch.float32, use_kernels=True):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.compute_dtype = dtype
        self.word_embeddings = Embed(cfg.vocab_size, E, dtype)
        self.position_embeddings = Embed(cfg.max_position_embeddings, E, dtype)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, E, dtype)
        self.LayerNorm = FusedLN(E, cfg.layer_norm_eps, use_kernels)

    def forward(self, input_ids, generator: Optional[torch.Generator] = None):
        pos_ids = roberta_position_ids(input_ids, self.cfg.pad_token_id)
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(pos_ids)
            + self.token_type_embeddings(torch.zeros_like(input_ids))
        )
        x = self.LayerNorm(x, out_dtype=self.compute_dtype)
        return dropout(x, self.cfg.hidden_dropout_prob, generator)


class RobertaLayer(nn.Module):
    def __init__(self, cfg: ChemBertaConfig, dtype=torch.float32, use_kernels=True):
        super().__init__()
        E = cfg.hidden_size
        self.cfg = cfg
        self.compute_dtype = dtype
        self.use_kernels = use_kernels
        self.act = get_activation_fn(cfg.hidden_act)
        self.attn_query = Dense(E, E, dtype)
        self.attn_key = Dense(E, E, dtype)
        self.attn_value = Dense(E, E, dtype)
        self.attn_output = Dense(E, E, dtype)
        self.attn_LayerNorm = FusedLN(E, cfg.layer_norm_eps, use_kernels)
        self.intermediate = Dense(E, cfg.intermediate_size, dtype)
        self.output = Dense(cfg.intermediate_size, E, dtype)
        self.output_LayerNorm = FusedLN(E, cfg.layer_norm_eps, use_kernels)

    def forward(self, x, key_mask_bias, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        ctx = masked_attention(
            self.attn_query(x), self.attn_key(x), self.attn_value(x), key_mask_bias,
            num_heads=cfg.num_attention_heads, dropout_rate=cfg.attention_probs_dropout_prob,
            seed=draw_seed(generator, cfg.attention_probs_dropout_prob),
            deterministic=generator is None, use_kernels=self.use_kernels,
        )
        ctx = dropout(self.attn_output(ctx), cfg.hidden_dropout_prob, generator)
        x = self.attn_LayerNorm(ctx + x, out_dtype=self.compute_dtype)
        out = self.output(self.act(self.intermediate(x)))
        out = dropout(out, cfg.hidden_dropout_prob, generator)
        return self.output_LayerNorm(out + x, out_dtype=self.compute_dtype)


class ChemBerta(nn.Module):
    def __init__(self, cfg: ChemBertaConfig, dtype=torch.float32, use_kernels=True):
        super().__init__()
        self.cfg = cfg
        self.embeddings = RobertaEmbeddings(cfg, dtype, use_kernels)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", RobertaLayer(cfg, dtype, use_kernels))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """input_ids/attention_mask [B,L] -> last_hidden_state [B,L,E]."""
        x = self.embeddings(input_ids, generator)
        # HF extended mask: (1-mask) * large negative, over keys
        neg = torch.finfo(torch.float32).min
        key_mask_bias = (1.0 - attention_mask.float()) * neg
        for i in range(self.cfg.num_hidden_layers):
            x = getattr(self, f"layer_{i}")(x, key_mask_bias, generator)
        return x
