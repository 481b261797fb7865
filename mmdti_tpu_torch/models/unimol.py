"""Uni-Mol-style 3D conformer transformer encoder (port of
mmdti_tpu/models/unimol.py).

Embedding LayerNorm, N pre-LN layers each consuming the incoming pair bias
and emitting its pre-softmax logits as the outgoing bias, final LayerNorm,
token/pair norm terms and the delta-pair representation.  Softmax and
logits accumulate in fp32 while the projections run in the compute dtype;
the threaded [B,H,N,N] logits are stored in ``cfg.pair_dtype``.  With a
``generator`` the forward applies the embedding, attention, activation and
residual dropouts of the JAX encoder (models/layers.py).  With
``cfg.remat`` and autograd on, each layer runs under
``torch.utils.checkpoint`` (non-reentrant), the twin of the JAX encoder's
``nn.remat``: its inner activations are dropped after the forward and
recomputed in the backward, from the layer's input, its incoming pair bias
and its draws (``PairBiasEncoderLayer.draw``, made once before the layer),
so a step with remat is bit-equal to one without.  The incoming pair bias
is a checkpoint input, so the chain of [B,H,N,N] logits stays resident.

With a sharding model group (parallel/mesh.py) each layer holds this
shard's H/m heads of ``in_proj`` (from each of its q, k and v thirds),
``out_proj``'s matching input columns, and F/m columns of ``fc1`` and
``fc2``; the pair-bias kernels run on the shard's heads at their place
among the layer's, and each shard threads its own [B, H/m, N, N] chain.
Only ``pair_outputs`` gathers the heads (the final head LayerNorm and the
delta-pair norm read all H); the train and serve paths never ask for them.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmdti_tpu_torch.configs.architectures import UniMolEncoderConfig
from mmdti_tpu_torch.models.layers import (
    Dense,
    LayerNormFP32,
    apply_keep,
    draw_keep,
    draw_seed,
    dropout,
    get_activation_fn,
    row_dense,
    tensor_parallel,
)
from mmdti_tpu_torch.ops.attention import pair_bias_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


class Draws(NamedTuple):
    """One encoder layer's random draws (None where nothing drops)."""

    deterministic: bool
    seed: Optional[torch.Tensor]          # the attention call's int32 seed
    attn_out: Optional[torch.Tensor]      # keep masks, bool
    activation: Optional[torch.Tensor]
    out: Optional[torch.Tensor]


class PairBiasEncoderLayer(nn.Module):
    def __init__(self, cfg: UniMolEncoderConfig, dtype=torch.float32, use_kernels=True,
                 group=None):
        super().__init__()
        E, F = cfg.embed_dim, cfg.ffn_embed_dim
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.group = group = tensor_parallel(group)
        m = group.size if group else 1
        self.act = get_activation_fn(cfg.activation_fn)
        self.self_attn_layer_norm = LayerNormFP32(E, use_kernels=use_kernels)
        self.in_proj = Dense(E, 3 * E // m, dtype)
        self.out_proj = row_dense(E, E, dtype, group)
        self.final_layer_norm = LayerNormFP32(E, use_kernels=use_kernels)
        self.fc1 = Dense(E, F // m, dtype)
        self.fc2 = row_dense(F, E, dtype, group)
        # this shard's heads among the layer's, and its FFN columns
        self.heads = cfg.attention_heads // m
        self.head_span = None if group is None else (group.span(cfg.attention_heads)[0],
                                                     cfg.attention_heads)
        self.ffn_columns = None if group is None else group.span(F)

    def draw(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> Draws:
        """The layer's random draws for input ``x``, in the order its
        computation uses them: the attention call's seed, then the keep
        masks of the attention output, the activation and the layer output.
        A philox or Mersenne stream gives the same numbers to the same
        calls in the same order, so drawing them before the layer runs
        changes nothing; a recomputed layer (remat) takes them as inputs
        and never touches the generator."""
        cfg = self.cfg
        return Draws(generator is None, draw_seed(generator, cfg.attention_dropout),
                     draw_keep(generator, cfg.dropout, x.shape, x.device),
                     draw_keep(generator, cfg.activation_dropout,
                               (*x.shape[:-1], cfg.ffn_embed_dim), x.device,
                               columns=self.ffn_columns),
                     draw_keep(generator, cfg.dropout, x.shape, x.device))

    def forward(self, x, bias, draws: "Draws"):
        """x [B,N,E], bias [B,H,N,N] (this shard's H/m heads under tensor
        parallelism), the layer's ``draws`` -> (x', new_bias)."""
        cfg = self.cfg
        residual = x
        h = self.self_attn_layer_norm(x)
        q, k, v = self.in_proj(h if self.group is None else self.group.copy(h)).chunk(3, dim=-1)
        attn, new_bias = pair_bias_attention(
            q, k, v, bias, num_heads=self.heads,
            pair_dtype=torch_dtype(cfg.pair_dtype), dropout_rate=cfg.attention_dropout,
            seed=draws.seed, deterministic=draws.deterministic, use_kernels=self.use_kernels,
            head_span=self.head_span,
        )
        x = residual + apply_keep(self.out_proj(attn), draws.attn_out, cfg.dropout)
        residual = x
        h = self.final_layer_norm(x)
        x = self.act(self.fc1(h if self.group is None else self.group.copy(h)))
        x = self.fc2(apply_keep(x, draws.activation, cfg.activation_dropout))
        return residual + apply_keep(x, draws.out, cfg.dropout), new_bias


def _norm_loss(x, eps=1e-10, tolerance=1.0):
    x = x.float()
    max_norm = x.shape[-1] ** 0.5
    norm = torch.sqrt(torch.sum(x * x, dim=-1) + eps)
    return torch.relu(torch.abs(norm - max_norm) - tolerance)


def _masked_mean(mask, value, dim=-1, eps=1e-10):
    return (torch.sum(mask * value, dim=dim) / (eps + torch.sum(mask, dim=dim))).mean()


class UniMolEncoder(nn.Module):
    def __init__(self, cfg: UniMolEncoderConfig, dtype=torch.float32, use_kernels=True,
                 group=None):
        super().__init__()
        E = cfg.embed_dim
        self.cfg = cfg
        self.group = tensor_parallel(group)
        self.emb_layer_norm = LayerNormFP32(E, use_kernels=use_kernels)
        for i in range(cfg.encoder_layers):
            self.add_module(f"layers_{i}", PairBiasEncoderLayer(cfg, dtype, use_kernels, group))
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
        final logits and the [B,N,N,H] delta-pair tensor are not computed;
        ``pair_outputs="logits"`` returns ``rep`` and the last layer's
        logits ``pair_logits`` [B,H,N,N] (in the pair dtype, -inf at padded
        keys), which the docking model threads on (models/docking.py)."""
        cfg = self.cfg
        x = dropout(self.emb_layer_norm(emb), cfg.emb_dropout, generator)
        if padding_mask is not None:
            x = x * (1.0 - padding_mask[..., None].to(x.dtype))

        input_bias = attn_bias.to(torch_dtype(cfg.pair_dtype))
        bias = input_bias
        # remat: each layer's activations are recomputed in the backward
        # (flax nn.remat); its draws are made once, outside, so the
        # recomputation replays them and the generator advances as without
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.encoder_layers):
            layer = getattr(self, f"layers_{i}")
            draws = layer.draw(x, generator)
            if remat:
                x, bias = checkpoint(layer, x, bias, draws, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                x, bias = layer(x, bias, draws)

        if not pair_outputs:
            return {"rep": self.final_layer_norm(x) if not cfg.post_ln else x}
        if pair_outputs == "logits":
            return {"rep": self.final_layer_norm(x) if not cfg.post_ln else x,
                    "pair_logits": bias}

        token_norm = _norm_loss(x)
        if padding_mask is not None:
            token_mask = 1.0 - padding_mask.float()
        else:
            token_mask = torch.ones_like(token_norm)
        x_norm = _masked_mean(token_mask, token_norm)

        if not cfg.post_ln:
            x = self.final_layer_norm(x)

        if self.group is not None:
            # the pair outputs read every head
            bias = self.group.gather(bias, 1)
            input_bias = self.group.gather(input_bias, 1)
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
