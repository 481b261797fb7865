"""Uni-Mol-style 3D conformer transformer encoder (port of
mmdti_tpu/models/unimol.py).

Embedding LayerNorm, N pre-LN layers each consuming the incoming pair bias
and emitting its pre-softmax logits as the outgoing bias, final LayerNorm,
token/pair norm terms and the delta-pair representation.  Softmax and
logits accumulate in fp32 while the projections run in the compute dtype;
the threaded [B,H,N,N] logits are stored in ``cfg.pair_dtype``.  With a
``generator`` the forward applies the embedding, attention, activation and
residual dropouts of the JAX encoder (models/layers.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from mmdti_tpu_torch.configs.architectures import UniMolEncoderConfig
from mmdti_tpu_torch.models.layers import (
    Dense,
    LayerNormFP32,
    draw_seed,
    dropout,
    get_activation_fn,
)
from mmdti_tpu_torch.ops.attention import pair_bias_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


class PairBiasEncoderLayer(nn.Module):
    def __init__(self, cfg: UniMolEncoderConfig, dtype=torch.float32, use_kernels=True):
        super().__init__()
        E = cfg.embed_dim
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.act = get_activation_fn(cfg.activation_fn)
        self.self_attn_layer_norm = LayerNormFP32(E, use_kernels=use_kernels)
        self.in_proj = Dense(E, 3 * E, dtype)
        self.out_proj = Dense(E, E, dtype)
        self.final_layer_norm = LayerNormFP32(E, use_kernels=use_kernels)
        self.fc1 = Dense(E, cfg.ffn_embed_dim, dtype)
        self.fc2 = Dense(cfg.ffn_embed_dim, E, dtype)

    def forward(self, x, bias, generator: Optional[torch.Generator] = None):
        """x [B,N,E], bias [B,H,N,N] -> (x', new_bias)."""
        cfg = self.cfg
        residual = x
        q, k, v = self.in_proj(self.self_attn_layer_norm(x)).chunk(3, dim=-1)
        attn, new_bias = pair_bias_attention(
            q, k, v, bias, num_heads=cfg.attention_heads,
            pair_dtype=torch_dtype(cfg.pair_dtype), dropout_rate=cfg.attention_dropout,
            seed=draw_seed(generator, cfg.attention_dropout),
            deterministic=generator is None, use_kernels=self.use_kernels,
        )
        x = residual + dropout(self.out_proj(attn), cfg.dropout, generator)
        residual = x
        x = self.act(self.fc1(self.final_layer_norm(x)))
        x = self.fc2(dropout(x, cfg.activation_dropout, generator))
        return residual + dropout(x, cfg.dropout, generator), new_bias


def _norm_loss(x, eps=1e-10, tolerance=1.0):
    x = x.float()
    max_norm = x.shape[-1] ** 0.5
    norm = torch.sqrt(torch.sum(x * x, dim=-1) + eps)
    return torch.relu(torch.abs(norm - max_norm) - tolerance)


def _masked_mean(mask, value, dim=-1, eps=1e-10):
    return (torch.sum(mask * value, dim=dim) / (eps + torch.sum(mask, dim=dim))).mean()


class UniMolEncoder(nn.Module):
    def __init__(self, cfg: UniMolEncoderConfig, dtype=torch.float32, use_kernels=True):
        super().__init__()
        E = cfg.embed_dim
        self.cfg = cfg
        self.emb_layer_norm = LayerNormFP32(E, use_kernels=use_kernels)
        for i in range(cfg.encoder_layers):
            self.add_module(f"layers_{i}", PairBiasEncoderLayer(cfg, dtype, use_kernels))
        if not cfg.post_ln:
            self.final_layer_norm = LayerNormFP32(E, use_kernels=use_kernels)
        if cfg.delta_pair_repr_norm_loss >= 0:
            self.final_head_layer_norm = LayerNormFP32(cfg.attention_heads,
                                                       use_kernels=use_kernels)

    def forward(
        self,
        emb: torch.Tensor,                     # [B,N,E]
        attn_bias: torch.Tensor,               # [B,H,N,N] pair bias, -inf at pad keys
        padding_mask: Optional[torch.Tensor],  # [B,N] bool, True at pads
        pair_outputs: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """``attn_bias`` arrives with the padding already merged in (the
        fused gbf kernel writes it so).  The JAX encoder merges here
        instead; the outputs are the same, because the delta-pair terms are
        zeroed at padded keys, the only place the two biases differ.

        ``pair_outputs=False`` returns only ``rep``: the norm terms, the
        final logits and the [B,N,N,H] delta-pair tensor are not computed."""
        cfg = self.cfg
        x = dropout(self.emb_layer_norm(emb), cfg.emb_dropout, generator)
        if padding_mask is not None:
            x = x * (1.0 - padding_mask[..., None].to(x.dtype))

        input_bias = attn_bias.to(torch_dtype(cfg.pair_dtype))
        bias = input_bias
        for i in range(cfg.encoder_layers):
            x, bias = getattr(self, f"layers_{i}")(x, bias, generator)

        if not pair_outputs:
            return {"rep": self.final_layer_norm(x) if not cfg.post_ln else x}

        token_norm = _norm_loss(x)
        if padding_mask is not None:
            token_mask = 1.0 - padding_mask.float()
        else:
            token_mask = torch.ones_like(token_norm)
        x_norm = _masked_mean(token_mask, token_norm)

        if not cfg.post_ln:
            x = self.final_layer_norm(x)

        # delta pair representation: accumulated logits minus the input
        # bias, zeroed at padded keys, [B,N,N,H]
        delta = bias.float() - input_bias.float()
        if padding_mask is not None:
            delta = delta.masked_fill(padding_mask[:, None, None, :], 0.0)
        delta_pair = delta.permute(0, 2, 3, 1)
        pair_mask = token_mask[..., None] * token_mask[..., None, :]
        delta_norm = _masked_mean(pair_mask, _norm_loss(delta_pair), dim=(-1, -2))

        if cfg.delta_pair_repr_norm_loss >= 0:
            delta_pair = self.final_head_layer_norm(delta_pair)

        return {
            "rep": x,                                  # [B,N,E]
            "pair_logits": bias,                       # [B,H,N,N]
            "delta_pair_repr": delta_pair,             # [B,N,N,H]
            "x_norm": x_norm,
            "delta_pair_repr_norm": delta_norm,
        }
