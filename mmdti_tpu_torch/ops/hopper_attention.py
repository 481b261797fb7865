"""Hand-written Hopper kernels for the two attentions, forward and backward,
with their plain PyTorch versions.

* ``pair_bias_attention_fused`` replaces the TPU kernels
  mmdti_tpu/ops/pallas_attention.py::_fwd_kernel and ``_bwd_kernel``: the
  Uni-Mol layer's ``logits = (q*D^-1/2) k^T + bias``,
  ``out = dropout(softmax(logits)) v``, returning the pre-dropout logits in
  the pair dtype as the next layer's bias.  CUDA source:
  csrc/pair_bias_attention.cu.
* ``masked_attention_fused`` replaces ``_masked_fwd_kernel`` and
  ``_masked_bwd_kernel``: BERT-style attention with an additive per-key mask
  [B, Nk] (ChemBERTa and the cross-modal layers, Nq != Nk allowed).  CUDA
  source: csrc/masked_attention.cu, two routes by dtype: bf16 runs
  flash-style tensor-core kernels whose forward also returns row stats
  for the backward ("mma"), fp32 runs the row kernels ("rows").

Both take token-major q/k/v [B, L, H*D] (heads contiguous on the last dim)
and return token-major outputs.  Each is a ``torch.autograd.Function``
whose forward and backward pick by the tensors' device: a CPU tensor runs
the plain version below, a CUDA tensor launches the kernel or raises.  The
softmax runs in fp32 with the TPU kernels' guard for fully-masked rows (a
non-finite row max is replaced by 0, the row sum is floored at 1e-30).
Attention dropout draws its keep mask from ops/dropout.py's pure function of
(seed, b, h, i, j), so the forward, the backward that replays it and the
plain versions drop the same probabilities; ``seed`` is one int32 in a
tensor on the inputs' device.

Each ``*_cuda`` launcher counts its launches in ``<fn>.launches``; the
masked launchers also count them per route in ``<fn>.routes``.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmdti_tpu_torch.ops import _build
from mmdti_tpu_torch.ops import dropout as drop


def split_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    B, L, E = t.shape
    return t.reshape(B, L, H, E // H).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    B, H, L, D = t.shape
    return t.transpose(1, 2).reshape(B, L, H * D)


def guarded_max(logits: torch.Tensor) -> torch.Tensor:
    """Row max [..., 1] with a non-finite max replaced by 0 (the TPU
    kernels' fully-masked-row guard, pallas_attention.py:68-76)."""
    m = logits.amax(dim=-1, keepdim=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def guarded_softmax_parts(logits: torch.Tensor):
    """(p_un, inv_s): unnormalised fp32 probabilities and the row constant
    1/rowsum, with the fully-masked-row guard."""
    p = torch.exp(logits - guarded_max(logits))
    return p, 1.0 / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def guarded_softmax_pv(logits: torch.Tensor, v: torch.Tensor,
                       keep: Optional[torch.Tensor] = None,
                       dropout_rate: float = 0.0) -> torch.Tensor:
    """dropout(softmax(logits)) @ v in fp32 with the fully-masked-row guard.

    logits [B,H,Nq,Nk] fp32, v [B,H,Nk,D] fp32, keep [B,H,Nq,Nk] bool or
    None -> [B,H,Nq,D] fp32.  Dropped probabilities are zeroed after the row
    sum and 1/(1-rate) is folded into the row constant, as the TPU kernels'
    _softmax_factored does."""
    p, inv_s = guarded_softmax_parts(logits)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), dtype=p.dtype, device=p.device))
        inv_s = inv_s * drop.keep_scale(dropout_rate)
    return torch.matmul(p, v) * inv_s


def keep_mask_for(seed, dropout_rate: float, B: int, H: int, Nq: int, Nk: int, device):
    """The call's dropout keep mask [B,H,Nq,Nk] (ops/dropout.py), or None
    without dropout."""
    if dropout_rate <= 0.0:
        return None
    return drop.keep_mask(int(seed), dropout_rate, B, H, Nq, Nk, device=device)


def _attention_bwd_core(qh, kh, vh, logits, g_h, g_logits, keep, dropout_rate, scale):
    """The TPU kernels' _attention_bwd_core plus the dq/dk/dv products, in
    fp32 on [B,H,L,D] heads.  g_h (the output cotangent) and g_logits may be
    None.  Returns (dq, dk, dv, dL) head-major."""
    p_un, inv_s = guarded_softmax_parts(logits)
    if g_h is None:
        dl = torch.zeros_like(logits)
        dv = torch.zeros_like(vh)
    else:
        dp = torch.matmul(g_h, vh.transpose(-1, -2))
        g_scale = inv_s
        pd_un = p_un
        if keep is not None:
            c = drop.keep_scale(dropout_rate)
            zero = torch.zeros((), dtype=dp.dtype, device=dp.device)
            dp = torch.where(keep, dp * c, zero)
            pd_un = torch.where(keep, p_un, zero)
            g_scale = inv_s * c
        r = (dp * p_un).sum(dim=-1, keepdim=True) * inv_s
        dl = p_un * ((dp - r) * inv_s)
        dv = torch.matmul(pd_un.transpose(-1, -2), g_h * g_scale)
    if g_logits is not None:
        dl = dl + g_logits.float()
    dq = torch.matmul(dl, kh) * scale
    dk = torch.matmul(dl.transpose(-1, -2), qh) * scale
    return dq, dk, dv, dl


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
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{n} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")


def _dropout_args(seed: Optional[torch.Tensor], dropout_rate: float, device):
    """(seed pointer or None, uint32 threshold, keep scale) for a launch."""
    if dropout_rate <= 0.0:
        return None, 0, 1.0
    if not (torch.is_tensor(seed) and seed.dtype == torch.int32 and seed.numel() == 1
            and seed.device == device):
        raise ValueError(f"attention dropout needs seed as one int32 on {device}")
    return seed.data_ptr(), drop.threshold(dropout_rate), drop.keep_scale(dropout_rate)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_heads(q, k, v, num_heads, what):
    B, Nq, E = q.shape
    Nk = k.shape[1]
    if E % num_heads or k.shape != (B, Nk, E) or v.shape != k.shape:
        raise ValueError(
            f"{what} shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"H={num_heads}"
        )
    if E // num_heads not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head dims {HEAD_DIMS}, got {E // num_heads}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    return B, Nq, Nk, E // num_heads


def effective_rate(dropout_rate: float, seed, deterministic: bool) -> float:
    """The attention-dropout rate a call applies: 0 when deterministic; a
    rate above 0 needs a seed."""
    rate = 0.0 if deterministic else float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    return rate


# ---------------------------------------------------------------------------
# pair-bias attention
# ---------------------------------------------------------------------------


def pair_bias_attention_plain(q, k, v, bias, num_heads: int, pair_dtype=torch.float32,
                              seed=None, dropout_rate: float = 0.0):
    """Plain version of the pair-bias forward kernel.

    q/k/v [B,N,H*D], bias [B,H,N,N] (-inf at padded keys) ->
    (out [B,N,H*D] in q.dtype, logits [B,H,N,N] in pair_dtype)."""
    H = num_heads
    B, N, E = q.shape
    D = E // H
    qh, kh, vh = (split_heads(t, H).float() for t in (q, k, v))
    logits = torch.matmul(qh * D ** -0.5, kh.transpose(-1, -2)) + bias.float()
    keep = keep_mask_for(seed, dropout_rate, B, H, N, N, q.device)
    out = guarded_softmax_pv(logits, vh, keep, dropout_rate)
    return merge_heads(out).to(q.dtype), logits.to(pair_dtype)


def pair_bias_attention_bwd_plain(q, k, v, logits, g_out, g_logits, num_heads: int,
                                  seed=None, dropout_rate: float = 0.0):
    """Plain version of the pair-bias backward kernel: from the stored
    logits, replaying the forward's dropout mask.  g_out [B,N,H*D] and
    g_logits [B,H,N,N] may be None.  Returns (dq, dk, dv) in q.dtype and
    dbias in logits.dtype."""
    H = num_heads
    B, N, E = q.shape
    D = E // H
    qh, kh, vh = (split_heads(t, H).float() for t in (q, k, v))
    g_h = None if g_out is None else split_heads(g_out, H).float()
    keep = keep_mask_for(seed, dropout_rate, B, H, N, N, q.device)
    dq, dk, dv, dl = _attention_bwd_core(qh, kh, vh, logits.float(), g_h, g_logits, keep,
                                         dropout_rate, D ** -0.5)
    return (merge_heads(dq).to(q.dtype), merge_heads(dk).to(k.dtype),
            merge_heads(dv).to(v.dtype), dl.to(logits.dtype))


def pair_bias_attention_cuda(q, k, v, bias, num_heads: int, seed=None,
                             dropout_rate: float = 0.0):
    """Launch csrc/pair_bias_attention.cu's forward.  The logits come back
    in bias.dtype (the pair dtype)."""
    _require_cuda((q, k, v, bias), ("q", "k", "v", "bias"))
    B, N, _, D = _check_heads(q, k, v, num_heads, "pair-bias attention")
    H = num_heads
    if k.shape[1] != N or bias.shape != (B, H, N, N):
        raise ValueError(f"pair-bias attention: bias {tuple(bias.shape)} for q {tuple(q.shape)}")
    seed_p, thr, scale = _dropout_args(seed, dropout_rate, q.device)
    out = torch.empty_like(q)
    logits = torch.empty_like(bias)
    lib = _build.load("pair_bias_attention")
    rc = lib.mmdti_pair_bias_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        logits.data_ptr(), seed_p, thr, scale, B, N, H, D, _dtype_flag(q, "q"),
        _dtype_flag(bias, "bias"), _stream(q),
    )
    _build.check(rc, f"pair_bias_attention (B={B}, N={N}, H={H}, D={D})")
    pair_bias_attention_cuda.launches += 1
    return out, logits


pair_bias_attention_cuda.launches = 0


def pair_bias_attention_bwd_cuda(q, k, v, logits, g_out, g_logits, num_heads: int,
                                 seed=None, dropout_rate: float = 0.0):
    """Launch csrc/pair_bias_attention.cu's backward (two kernels).  g_out
    and g_logits may be None: the kernel then reads nothing for them."""
    _require_cuda((q, k, v, logits, g_out, g_logits),
                  ("q", "k", "v", "logits", "g_out", "g_logits"))
    B, N, _, D = _check_heads(q, k, v, num_heads, "pair-bias attention")
    H = num_heads
    if logits.shape != (B, H, N, N):
        raise ValueError(f"pair-bias backward: logits {tuple(logits.shape)} for q {tuple(q.shape)}")
    if g_out is not None and (g_out.shape != q.shape or g_out.dtype != q.dtype):
        raise ValueError("g_out must match q in shape and dtype")
    if g_logits is not None and (g_logits.shape != logits.shape
                                 or g_logits.dtype != logits.dtype):
        raise ValueError("g_logits must match the logits in shape and dtype")
    seed_p, thr, scale = _dropout_args(seed, dropout_rate, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(logits)
    stats = torch.empty((B, H, N, 3), dtype=torch.float32, device=q.device)
    lib = _build.load("pair_bias_attention")
    rc = lib.mmdti_pair_bias_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), logits.data_ptr(), _ptr(g_out),
        _ptr(g_logits), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
        stats.data_ptr(), seed_p, thr, scale, B, N, H, D, _dtype_flag(q, "q"),
        _dtype_flag(logits, "logits"), _stream(q),
    )
    _build.check(rc, f"pair_bias_attention_bwd (B={B}, N={N}, H={H}, D={D})")
    pair_bias_attention_bwd_cuda.launches += 1
    return dq, dk, dv, dbias


pair_bias_attention_bwd_cuda.launches = 0


class PairBiasAttention(torch.autograd.Function):
    """The pair-bias kernel pair as one differentiable op: apply(q, k, v,
    bias, num_heads, seed, dropout_rate) -> (out, logits in bias.dtype).
    The backward gets None for an output the loss does not read (the last
    layer's logits) and passes it on as absent."""

    @staticmethod
    def forward(ctx, q, k, v, bias, num_heads, seed, dropout_rate):
        if q.device.type == "cpu":
            out, logits = pair_bias_attention_plain(q, k, v, bias, num_heads, bias.dtype,
                                                    seed, dropout_rate)
        else:
            out, logits = pair_bias_attention_cuda(q, k, v, bias, num_heads, seed,
                                                   dropout_rate)
        ctx.save_for_backward(q, k, v, logits)
        ctx.num_heads, ctx.seed, ctx.dropout_rate = num_heads, seed, dropout_rate
        ctx.set_materialize_grads(False)
        return out, logits

    @staticmethod
    def backward(ctx, g_out, g_logits):
        q, k, v, logits = ctx.saved_tensors
        if g_out is not None:
            g_out = g_out.to(q.dtype).contiguous()
        if g_logits is not None:
            g_logits = g_logits.to(logits.dtype).contiguous()
        bwd = pair_bias_attention_bwd_plain if q.device.type == "cpu" else pair_bias_attention_bwd_cuda
        dq, dk, dv, dbias = bwd(q, k, v, logits, g_out, g_logits, ctx.num_heads, ctx.seed,
                                ctx.dropout_rate)
        return dq, dk, dv, dbias, None, None, None


def pair_bias_attention_fused(q, k, v, bias, *, num_heads: int,
                              pair_dtype=torch.float32, dropout_rate: float = 0.0,
                              seed: Optional[torch.Tensor] = None,
                              deterministic: bool = True):
    """Token-major pair-bias attention, differentiable: the kernels for
    CUDA tensors, the plain versions for CPU tensors.  Returns (out, logits
    in pair_dtype).  With ``deterministic=False`` and a rate above 0 the
    probabilities are dropped by the keep mask of ``seed``."""
    rate = effective_rate(dropout_rate, seed, deterministic)
    bias = bias.to(pair_dtype)
    if q.device.type != "cpu":
        q, k, v, bias = (t.contiguous() for t in (q, k, v, bias))
    return PairBiasAttention.apply(q, k, v, bias, num_heads, seed if rate else None, rate)


# ---------------------------------------------------------------------------
# masked attention
# ---------------------------------------------------------------------------


def _masked_logits(qh, kh, mask, D):
    return torch.matmul(qh * D ** -0.5, kh.transpose(-1, -2)) + mask.float()[:, None, None, :]


def masked_route(dtype) -> str:
    """The kernel route of a masked-attention call: "mma" (tensor-core
    kernels) for bf16 q/k/v, "rows" (FMA row kernels) for fp32."""
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "rows"
    raise TypeError(f"q must be float32 or bfloat16, got {dtype}")


def masked_attention_plain(q, k, v, mask, num_heads: int, seed=None,
                           dropout_rate: float = 0.0):
    """Plain version of the forward kernels, whole rows at once.

    q [B,Nq,H*D], k/v [B,Nk,H*D], mask [B,Nk] additive fp32 ->
    (out [B,Nq,H*D] in q.dtype, stats [B,H,Nq,2] fp32): stats holds each
    row's guarded max and 1/rowsum, which the "mma" route's forward also
    returns for its backward."""
    H = num_heads
    B, Nq, E = q.shape
    D = E // H
    qh, kh, vh = (split_heads(t, H).float() for t in (q, k, v))
    logits = _masked_logits(qh, kh, mask, D)
    keep = keep_mask_for(seed, dropout_rate, B, H, Nq, k.shape[1], q.device)
    out = merge_heads(guarded_softmax_pv(logits, vh, keep, dropout_rate)).to(q.dtype)
    return out, torch.cat([guarded_max(logits), guarded_softmax_parts(logits)[1]], dim=-1)


def masked_attention_bwd_plain(q, k, v, mask, g_out, num_heads: int, seed=None,
                               dropout_rate: float = 0.0):
    """Plain version of the fp32 (row) backward kernels, and the oracle of
    both routes: recomputes the logits from q, k and the mask and replays
    the dropout mask.  Returns (dq, dk, dv); the mask gets no gradient."""
    H = num_heads
    B, Nq, E = q.shape
    D = E // H
    qh, kh, vh = (split_heads(t, H).float() for t in (q, k, v))
    g_h = None if g_out is None else split_heads(g_out, H).float()
    keep = keep_mask_for(seed, dropout_rate, B, H, Nq, k.shape[1], q.device)
    dq, dk, dv, _ = _attention_bwd_core(qh, kh, vh, _masked_logits(qh, kh, mask, D), g_h,
                                        None, keep, dropout_rate, D ** -0.5)
    return merge_heads(dq).to(q.dtype), merge_heads(dk).to(k.dtype), merge_heads(dv).to(v.dtype)


def masked_attention_stats_bwd_plain(q, k, v, mask, out, stats, g_out, num_heads: int,
                                     seed=None, dropout_rate: float = 0.0):
    """Plain version of the bf16 (tensor-core) backward kernels, whole rows
    at once: P from the forward's stats, r = rowsum(g_out * out),
    dS = P * (keep*c*dP - r).  Returns (dq, dk, dv) in q.dtype."""
    H = num_heads
    B, Nq, E = q.shape
    D = E // H
    qh, kh, vh, gh, oh = (split_heads(t, H).float() for t in (q, k, v, g_out, out))
    logits = _masked_logits(qh, kh, mask, D)
    p = torch.exp(logits - stats[..., :1]) * stats[..., 1:]
    r = (gh * oh).sum(dim=-1, keepdim=True)
    dp = torch.matmul(gh, vh.transpose(-1, -2))
    pd = p
    keep = keep_mask_for(seed, dropout_rate, B, H, Nq, k.shape[1], q.device)
    if keep is not None:
        c = drop.keep_scale(dropout_rate)
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        dp = torch.where(keep, dp * c, zero)
        pd = torch.where(keep, p * c, zero)
    ds = p * (dp - r)
    dq = torch.matmul(ds, kh) * D ** -0.5
    dk = torch.matmul(ds.transpose(-1, -2), qh) * D ** -0.5
    dv = torch.matmul(pd.transpose(-1, -2), gh)
    return tuple(merge_heads(t).to(q.dtype) for t in (dq, dk, dv))


def _check_mask(mask, B, Nk):
    if mask.shape != (B, Nk):
        raise ValueError(f"masked attention: mask {tuple(mask.shape)}, expected {(B, Nk)}")
    if mask.dtype != torch.float32:
        raise TypeError(f"mask must be float32, got {mask.dtype}")


def _require_aligned(tensors, names):
    """The tensor-core kernels load rows with 16-byte cp.async: each
    tensor's data must start on 16 bytes."""
    for t, n in zip(tensors, names):
        if t.data_ptr() % 16:
            raise ValueError(f"{n} must start on a 16-byte boundary for the bf16 kernels")


def masked_attention_cuda(q, k, v, mask, num_heads: int, seed=None,
                          dropout_rate: float = 0.0):
    """Launch csrc/masked_attention.cu's forward on the route of q's dtype.
    Returns (out, stats): stats [B,H,Nq,2] fp32 on the "mma" route, None on
    the "rows" route."""
    _require_cuda((q, k, v, mask), ("q", "k", "v", "mask"))
    B, Nq, Nk, D = _check_heads(q, k, v, num_heads, "masked attention")
    _check_mask(mask, B, Nk)
    route = masked_route(q.dtype)
    seed_p, thr, scale = _dropout_args(seed, dropout_rate, q.device)
    lib = _build.load("masked_attention")
    stats = None
    if route == "mma":
        _require_aligned((q, k, v), ("q", "k", "v"))
        out = torch.empty_like(q)
        stats = torch.empty((B, num_heads, Nq, 2), dtype=torch.float32, device=q.device)
        rc = lib.mmdti_masked_attention_mma_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            stats.data_ptr(), seed_p, thr, scale, B, Nq, Nk, num_heads, D, _stream(q))
    else:
        out = torch.empty_like(q)
        rc = lib.mmdti_masked_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            seed_p, thr, scale, B, Nq, Nk, num_heads, D, _stream(q))
    _build.check(rc, f"masked_attention {route} (B={B}, Nq={Nq}, Nk={Nk}, H={num_heads}, "
                     f"D={D})")
    masked_attention_cuda.launches += 1
    masked_attention_cuda.routes[route] += 1
    return out, stats


masked_attention_cuda.launches = 0
masked_attention_cuda.routes = {"mma": 0, "rows": 0}


def masked_attention_bwd_cuda(q, k, v, mask, out, stats, g_out, num_heads: int, seed=None,
                              dropout_rate: float = 0.0):
    """Launch csrc/masked_attention.cu's backward (two kernels) on the route
    of q's dtype.  The "mma" route reads the forward's out and stats and
    needs g_out; the "rows" route recomputes the logits, ignores out and
    stats, and takes g_out None (zero gradients)."""
    _require_cuda((q, k, v, mask, out, stats, g_out),
                  ("q", "k", "v", "mask", "out", "stats", "g_out"))
    B, Nq, Nk, D = _check_heads(q, k, v, num_heads, "masked attention")
    _check_mask(mask, B, Nk)
    if g_out is not None and (g_out.shape != q.shape or g_out.dtype != q.dtype):
        raise ValueError("g_out must match q in shape and dtype")
    route = masked_route(q.dtype)
    seed_p, thr, scale = _dropout_args(seed, dropout_rate, q.device)
    lib = _build.load("masked_attention")
    if route == "mma":
        if g_out is None or out is None or stats is None:
            raise ValueError("the bf16 masked backward needs g_out, out and stats")
        if out.shape != q.shape or stats.shape != (B, num_heads, Nq, 2):
            raise ValueError(f"masked backward: out {tuple(out.shape)}, stats "
                             f"{tuple(stats.shape)} for q {tuple(q.shape)}")
        _require_aligned((q, k, v, out, g_out), ("q", "k", "v", "out", "g_out"))
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        rsum = torch.empty((B, num_heads, Nq), dtype=torch.float32, device=q.device)
        rc = lib.mmdti_masked_attention_mma_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            g_out.data_ptr(), stats.data_ptr(), rsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), seed_p, thr, scale, B, Nq, Nk, num_heads, D, _stream(q))
    else:
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        ws = torch.empty((B, num_heads, Nq, 3), dtype=torch.float32, device=q.device)
        rc = lib.mmdti_masked_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), _ptr(g_out),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), seed_p, thr, scale,
            B, Nq, Nk, num_heads, D, _stream(q))
    _build.check(rc, f"masked_attention_bwd {route} (B={B}, Nq={Nq}, Nk={Nk}, H={num_heads}, "
                     f"D={D})")
    masked_attention_bwd_cuda.launches += 1
    masked_attention_bwd_cuda.routes[route] += 1
    return dq, dk, dv


masked_attention_bwd_cuda.launches = 0
masked_attention_bwd_cuda.routes = {"mma": 0, "rows": 0}


class MaskedAttention(torch.autograd.Function):
    """The masked kernel pair as one differentiable op: apply(q, k, v, mask,
    num_heads, seed, dropout_rate) -> out.  bf16 takes the "mma" route and
    saves out and the row stats for the backward; fp32 takes the "rows"
    route, whose backward recomputes everything.  CPU tensors run each
    route's plain versions.  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, num_heads, seed, dropout_rate):
        fwd = masked_attention_plain if q.device.type == "cpu" else masked_attention_cuda
        out, stats = fwd(q, k, v, mask, num_heads, seed, dropout_rate)
        saved = (out, stats) if masked_route(q.dtype) == "mma" else ()
        ctx.save_for_backward(q, k, v, mask, *saved)
        ctx.num_heads, ctx.seed, ctx.dropout_rate = num_heads, seed, dropout_rate
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_out):
        if g_out is None:
            return (None,) * 7
        q, k, v, mask, *saved = ctx.saved_tensors
        g_out = g_out.to(q.dtype).contiguous()
        rest = (ctx.num_heads, ctx.seed, ctx.dropout_rate)
        if q.device.type != "cpu":
            out, stats = saved or (None, None)
            dq, dk, dv = masked_attention_bwd_cuda(q, k, v, mask, out, stats, g_out, *rest)
        elif saved:
            dq, dk, dv = masked_attention_stats_bwd_plain(q, k, v, mask, *saved, g_out, *rest)
        else:
            dq, dk, dv = masked_attention_bwd_plain(q, k, v, mask, g_out, *rest)
        return dq, dk, dv, None, None, None, None


def masked_attention_fused(q, k, v, mask, *, num_heads: int, dropout_rate: float = 0.0,
                           seed: Optional[torch.Tensor] = None, deterministic: bool = True):
    """Token-major masked attention with an additive key mask [B, Nk],
    differentiable: the kernels for CUDA tensors, the plain versions for
    CPU tensors."""
    rate = effective_rate(dropout_rate, seed, deterministic)
    mask = mask.float()
    if q.device.type != "cpu":
        q, k, v, mask = (t.contiguous() for t in (q, k, v, mask))
    return MaskedAttention.apply(q, k, v, mask, num_heads, seed if rate else None, rate)
