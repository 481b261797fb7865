"""Pair-bias and masked attention: plain PyTorch oracles and the token-major
dispatchers the encoders call.

Port of mmdti_tpu/ops/attention.py.  Pair-bias semantics (unicore's
SelfMultiheadAttention as the reference uses it): each Uni-Mol layer
receives an additive per-head bias [B,H,N,N] that already carries -inf at
padded keys, computes

    logits = (q * head_dim**-0.5) @ k^T + bias
    out    = softmax(logits) @ v

and *returns the logits as the next layer's bias*.

Two implementations behind one call, as in the JAX package:
  * the oracle path (this file): head-major einsum-style math with an fp32
    softmax, the counterpart of the JAX XLA path (its attention dropout
    uses the kernels' keep mask, ops/dropout.py, so both paths drop the
    same probabilities for one seed);
  * the kernel path (ops/hopper_attention.py): the hand-written Hopper
    kernels for CUDA tensors, their plain versions for CPU tensors.
``use_kernels`` selects between them; the kernel path itself picks by
device and never falls back from a CUDA tensor to plain torch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmdti_tpu_torch.ops.hopper_attention import (
    effective_rate,
    keep_mask_for,
    merge_heads,
    split_heads,
    masked_attention_fused,
    pair_bias_attention_fused,
)


def pair_bias_attention_ref(
    q: torch.Tensor,      # [B, H, N, D]
    k: torch.Tensor,      # [B, H, N, D]
    v: torch.Tensor,      # [B, H, N, D]
    bias: torch.Tensor,   # [B, H, N, N] additive bias (with -inf pad fill)
    pair_dtype=torch.float32,
    keep: Optional[torch.Tensor] = None,   # [B, H, N, N] dropout keep mask
    dropout_rate: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (attention_output [B,H,N,D], new_bias [B,H,N,N]).

    Accumulation and softmax run in fp32; the probabilities are cast to the
    compute dtype before dropout and the PV product and the logits are
    stored in pair_dtype, as in the JAX XLA path."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    logits = logits + bias.float()
    probs = _dropout(torch.softmax(logits, dim=-1).to(q.dtype), keep, dropout_rate)
    out = torch.matmul(probs.float(), v.float())
    return out.to(q.dtype), logits.to(pair_dtype)


def _dropout(probs, keep, dropout_rate):
    """where(keep, probs / (1 - rate), 0), the XLA path's attention dropout
    (here with the kernels' keep mask, ops/dropout.py)."""
    if keep is None:
        return probs
    return torch.where(keep, probs / (1.0 - dropout_rate), torch.zeros_like(probs))


def merge_padding_into_bias(
    bias: torch.Tensor,                    # [B, H, N, N]
    padding_mask: Optional[torch.Tensor],  # [B, N] True where padded
    fill_value: float = float("-inf"),
    pair_dtype=torch.float32,
) -> torch.Tensor:
    """Fill padded *key* positions with -inf once before the stack
    (reference: fill_attn_mask, models/transformers.py:122-132)."""
    bias = bias.to(pair_dtype)
    if padding_mask is None:
        return bias
    return bias.masked_fill(padding_mask[:, None, None, :], fill_value)


def cross_attention_ref(
    q: torch.Tensor,                    # [B, H, Nq, D]
    k: torch.Tensor,                    # [B, H, Nk, D]
    v: torch.Tensor,                    # [B, H, Nk, D]
    mask_bias: Optional[torch.Tensor],  # additive, broadcastable to [B,H,Nq,Nk]
    keep: Optional[torch.Tensor] = None,   # [B, H, Nq, Nk] dropout keep mask
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """Plain additive-mask cross attention (BERT-style masks)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (q.shape[-1] ** 0.5)
    if mask_bias is not None:
        logits = logits + mask_bias.float()
    probs = _dropout(torch.softmax(logits, dim=-1).to(q.dtype), keep, dropout_rate)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Token-major dispatchers: inputs/outputs are [B, L, E]; the [B,H,L,D] layout
# exists only inside the oracle path.
# ---------------------------------------------------------------------------


def masked_attention(q_tok, k_tok, v_tok, key_mask_bias, *, num_heads,
                     dropout_rate=0.0, seed=None, deterministic=True, use_kernels=True):
    """[B,Lq,E] x [B,Lk,E] attention with an additive key mask [B, Lk]
    (ChemBERTa / cross-modal).  With ``deterministic=False`` the
    probabilities are dropped at ``dropout_rate`` by the keep mask of
    ``seed`` (one int32 tensor), on either path."""
    if use_kernels:
        return masked_attention_fused(
            q_tok, k_tok, v_tok, key_mask_bias, num_heads=num_heads,
            dropout_rate=dropout_rate, seed=seed, deterministic=deterministic,
        )
    H = num_heads
    rate = effective_rate(dropout_rate, seed, deterministic)
    B, Lq, _ = q_tok.shape
    ctx = cross_attention_ref(
        split_heads(q_tok, H), split_heads(k_tok, H), split_heads(v_tok, H),
        key_mask_bias[:, None, None, :],
        keep_mask_for(seed, rate, B, H, Lq, k_tok.shape[1], q_tok.device), rate,
    )
    return merge_heads(ctx)


def pair_bias_attention(q_tok, k_tok, v_tok, bias, *, num_heads, pair_dtype,
                        dropout_rate=0.0, seed=None, deterministic=True,
                        use_kernels=True):
    """[B,N,E] pair-bias attention returning (attn [B,N,E], new_bias); the
    dropout arguments as masked_attention's."""
    if use_kernels:
        return pair_bias_attention_fused(
            q_tok, k_tok, v_tok, bias, num_heads=num_heads, pair_dtype=pair_dtype,
            dropout_rate=dropout_rate, seed=seed, deterministic=deterministic,
        )
    H = num_heads
    rate = effective_rate(dropout_rate, seed, deterministic)
    B, N, _ = q_tok.shape
    attn, new_bias = pair_bias_attention_ref(
        split_heads(q_tok, H), split_heads(k_tok, H), split_heads(v_tok, H),
        bias, pair_dtype=pair_dtype,
        keep=keep_mask_for(seed, rate, B, H, N, N, q_tok.device), dropout_rate=rate,
    )
    return merge_heads(attn), new_bias
