"""ChemBERTa: RoBERTa-style SMILES transformer (port of
mmdti_tpu/models/chemberta.py).

RoBERTa position ids offset from the pad token, post-LN BERT blocks, fp32
LayerNorm and softmax, and the HF additive mask (1 - mask) * finfo(fp32).min
over keys.  With a ``generator`` the forward applies the hidden and
attention-probability dropouts of the JAX model (models/layers.py).  With
a sharding model group (parallel/mesh.py) each layer holds this shard's
heads of ``attn_query``/``attn_key``/``attn_value`` and the matching input
columns of ``attn_output``, and its columns of ``intermediate`` and
``output``.
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
    row_dense,
    tensor_parallel,
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
    def __init__(self, cfg: ChemBertaConfig, dtype=torch.float32, use_kernels=True, group=None):
        super().__init__()
        E, F, H = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
        self.cfg = cfg
        self.compute_dtype = dtype
        self.use_kernels = use_kernels
        self.group = group = tensor_parallel(group)
        m = group.size if group else 1
        self.heads = H // m
        self.head_span = None if group is None else (group.span(H)[0], H)
        self.act = get_activation_fn(cfg.hidden_act)
        self.attn_query = Dense(E, E // m, dtype)
        self.attn_key = Dense(E, E // m, dtype)
        self.attn_value = Dense(E, E // m, dtype)
        self.attn_output = row_dense(E, E, dtype, group)
        self.attn_LayerNorm = FusedLN(E, cfg.layer_norm_eps, use_kernels)
        self.intermediate = Dense(E, F // m, dtype)
        self.output = row_dense(F, E, dtype, group)
        self.output_LayerNorm = FusedLN(E, cfg.layer_norm_eps, use_kernels)

    def forward(self, x, key_mask_bias, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        h = x if self.group is None else self.group.copy(x)
        ctx = masked_attention(
            self.attn_query(h), self.attn_key(h), self.attn_value(h), key_mask_bias,
            num_heads=self.heads, dropout_rate=cfg.attention_probs_dropout_prob,
            seed=draw_seed(generator, cfg.attention_probs_dropout_prob),
            deterministic=generator is None, use_kernels=self.use_kernels,
            head_span=self.head_span,
        )
        ctx = dropout(self.attn_output(ctx), cfg.hidden_dropout_prob, generator)
        x = self.attn_LayerNorm(ctx + x, out_dtype=self.compute_dtype)
        h = x if self.group is None else self.group.copy(x)
        out = self.output(self.act(self.intermediate(h)))
        out = dropout(out, cfg.hidden_dropout_prob, generator)
        return self.output_LayerNorm(out + x, out_dtype=self.compute_dtype)


class ChemBerta(nn.Module):
    def __init__(self, cfg: ChemBertaConfig, dtype=torch.float32, use_kernels=True, group=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = RobertaEmbeddings(cfg, dtype, use_kernels)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", RobertaLayer(cfg, dtype, use_kernels, group))

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
