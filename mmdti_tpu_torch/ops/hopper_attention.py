"""Hand-written Hopper kernels for the two attention forwards, with their
plain PyTorch versions.

* ``pair_bias_attention_fused`` replaces the TPU kernel
  mmdti_tpu/ops/pallas_attention.py::_fwd_kernel: the Uni-Mol layer's
  ``logits = (q*D^-1/2) k^T + bias``, ``out = softmax(logits) v``, returning
  the logits in the pair dtype as the next layer's bias.  CUDA source:
  csrc/pair_bias_attention.cu.
* ``masked_attention_fused`` replaces ``_masked_fwd_kernel``: BERT-style
  attention with an additive per-key mask [B, Nk] (ChemBERTa and the
  cross-modal layers, Nq != Nk allowed).  CUDA source: csrc/masked_attention.cu.

Both take token-major q/k/v [B, L, H*D] (heads contiguous on the last dim)
and return token-major outputs.  Dispatch is by the tensors' device: a CPU
tensor runs the plain version below, a CUDA tensor launches the kernel or
raises.  The softmax runs in fp32 with the TPU kernels' guard for
fully-masked rows (a non-finite row max is replaced by 0, the row sum is
floored at 1e-30), so the plain versions and the kernels compute one
function.  Dropout is not implemented by the kernels (forward/serving only).

Each ``*_cuda`` launcher counts its launches in ``<fn>.launches``.
"""

from __future__ import annotations

import torch

from mmdti_tpu_torch.ops import _build


def split_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, L, E = t.shape
    return t.reshape(B, L, H, E // H).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    B, H, L, D = t.shape
    return t.transpose(1, 2).reshape(B, L, H * D)


def guarded_softmax_pv(logits: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(logits) @ v in fp32 with the fully-masked-row guard.

    logits [B,H,Nq,Nk] fp32, v [B,H,Nk,D] fp32 -> [B,H,Nq,D] fp32."""
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    inv_s = 1.0 / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(p, v) * inv_s


def _check_dropout(dropout_rate: float, deterministic: bool) -> None:
    if dropout_rate > 0.0 and not deterministic:
        raise NotImplementedError(
            "the attention kernels are forward-only and deterministic; "
            "attention dropout needs the backward kernels"
        )


# ---------------------------------------------------------------------------
# pair-bias attention
# ---------------------------------------------------------------------------


def pair_bias_attention_plain(q, k, v, bias, num_heads: int, pair_dtype=torch.float32):
    """Plain version of the pair-bias kernel.

    q/k/v [B,N,H*D], bias [B,H,N,N] (-inf at padded keys) ->
    (out [B,N,H*D] in q.dtype, logits [B,H,N,N] in pair_dtype)."""
    H = num_heads
    D = q.shape[-1] // H
    qh, kh, vh = (split_heads(t, H).float() for t in (q, k, v))
    logits = torch.matmul(qh * D ** -0.5, kh.transpose(-1, -2)) + bias.float()
    out = guarded_softmax_pv(logits, vh)
    return merge_heads(out).to(q.dtype), logits.to(pair_dtype)


def _dtype_flag(t: torch.Tensor, what: str) -> int:
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"{what} must be float32 or bfloat16, got {t.dtype}")


HEAD_DIMS = (8, 16, 32, 64)  # instantiated in csrc/attention_rows.cuh


def _require_cuda(tensors, names):
    dev = tensors[0].device
    for t, n in zip(tensors, names):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{n} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")


def pair_bias_attention_cuda(q, k, v, bias, num_heads: int):
    """Launch csrc/pair_bias_attention.cu.  The logits come back in
    bias.dtype (the pair dtype)."""
    _require_cuda((q, k, v, bias), ("q", "k", "v", "bias"))
    B, N, E = q.shape
    H = num_heads
    if E % H or k.shape != q.shape or v.shape != q.shape or bias.shape != (B, H, N, N):
        raise ValueError(
            f"pair-bias attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, bias {tuple(bias.shape)}, H={H}"
        )
    if E // H not in HEAD_DIMS:
        raise ValueError(f"pair-bias kernel takes head dims {HEAD_DIMS}, got {E // H}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    qkv_bf16 = _dtype_flag(q, "q")
    pair_bf16 = _dtype_flag(bias, "bias")
    out = torch.empty_like(q)
    logits = torch.empty_like(bias)
    lib = _build.load("pair_bias_attention")
    rc = lib.mmdti_pair_bias_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), logits.data_ptr(), B, N, H, E // H, qkv_bf16, pair_bf16,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, f"pair_bias_attention (B={B}, N={N}, H={H}, D={E // H})")
    pair_bias_attention_cuda.launches += 1
    return out, logits


pair_bias_attention_cuda.launches = 0


def pair_bias_attention_fused(q, k, v, bias, *, num_heads: int,
                              pair_dtype=torch.float32, dropout_rate: float = 0.0,
                              deterministic: bool = True):
    """Token-major pair-bias attention: the kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (out, logits in pair_dtype)."""
    _check_dropout(dropout_rate, deterministic)
    if q.device.type == "cpu":
        return pair_bias_attention_plain(q, k, v, bias, num_heads, pair_dtype)
    return pair_bias_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        bias.to(pair_dtype).contiguous(), num_heads,
    )


# ---------------------------------------------------------------------------
# masked attention
# ---------------------------------------------------------------------------


def masked_attention_plain(q, k, v, mask, num_heads: int):
    """Plain version of the masked kernel.

    q [B,Nq,H*D], k/v [B,Nk,H*D], mask [B,Nk] additive fp32 ->
    out [B,Nq,H*D] in q.dtype."""
    H = num_heads
    D = q.shape[-1] // H
    qh, kh, vh = (split_heads(t, H).float() for t in (q, k, v))
    logits = torch.matmul(qh * D ** -0.5, kh.transpose(-1, -2))
    logits = logits + mask.float()[:, None, None, :]
    return merge_heads(guarded_softmax_pv(logits, vh)).to(q.dtype)


def masked_attention_cuda(q, k, v, mask, num_heads: int):
    """Launch csrc/masked_attention.cu."""
    _require_cuda((q, k, v, mask), ("q", "k", "v", "mask"))
    B, Nq, E = q.shape
    Nk = k.shape[1]
    H = num_heads
    if E % H or k.shape != (B, Nk, E) or v.shape != k.shape or mask.shape != (B, Nk):
        raise ValueError(
            f"masked attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, mask {tuple(mask.shape)}, H={H}"
        )
    if E // H not in HEAD_DIMS:
        raise ValueError(f"masked kernel takes head dims {HEAD_DIMS}, got {E // H}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32, got {mask.dtype}")
    qkv_bf16 = _dtype_flag(q, "q")
    out = torch.empty_like(q)
    lib = _build.load("masked_attention")
    rc = lib.mmdti_masked_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, Nq, Nk, H, E // H, qkv_bf16,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(rc, f"masked_attention (B={B}, Nq={Nq}, Nk={Nk}, H={H}, D={E // H})")
    masked_attention_cuda.launches += 1
    return out


masked_attention_cuda.launches = 0


def masked_attention_fused(q, k, v, mask, *, num_heads: int, dropout_rate: float = 0.0,
                           deterministic: bool = True):
    """Token-major masked attention with an additive key mask [B, Nk]: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_dropout(dropout_rate, deterministic)
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, mask, num_heads)
    return masked_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        mask.float().contiguous(), num_heads,
    )
