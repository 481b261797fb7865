"""Hand-written Hopper kernels for the fused LayerNorm, forward and backward,
with their plain PyTorch versions and the gate that decides where they run.

``layer_norm_fused`` replaces the TPU kernels
mmdti_tpu/ops/pallas_ln.py::_fwd_kernel and ``_bwd_kernel``: an fp32
LayerNorm over the last axis with the fast variance
``max(E[x^2] - E[x]^2, 0)``, epsilon inside the rsqrt, the fp32 affine, and
the result cast to ``out_dtype``.  The forward saves only x and scale; the
backward recomputes the statistics from the same fp32 cast of x, returns dx
in x's dtype and dscale/dbias in fp32, summed over every row.

The kernels are bytes-bound on the H100: at [2048, 512] bf16 the forward
moves 4.2 MB (1.25 us at 3.35 TB/s) and the backward 6.3 MB (1.9 us); the
top atom bucket (N=280) moves 4.4 times as much.  CUDA source:
csrc/layer_norm.cu.  A CPU tensor runs the plain versions below, a CUDA
tensor launches the kernels or raises.  The launchers count their launches
in ``layer_norm_cuda.launches``, ``layer_norm_bwd_cuda.launches`` and
``layer_norm_bwd_reduce_cuda.launches``.

The gate is the JAX package's (pallas_ln.py:73-100): opt in with
``MMDTI_PALLAS_LN=1`` (read at every call), E % 128 == 0 and T % 8 == 0,
so the same LayerNorm sites engage in both packages.
"""

from __future__ import annotations

import os

import torch

from mmdti_tpu_torch.ops import _build

MAX_E = 1024          # widest row csrc/layer_norm.cu takes
ROWS_PER_BLOCK = 8    # kWarps in csrc/layer_norm.cu


def layer_norm_supported(shape) -> bool:
    """True when the kernels take this activation shape (pallas_ln.py's
    rule: rank >= 2, E % 128 == 0, T % 8 == 0, T > 0)."""
    if len(shape) < 2:
        return False
    T = 1
    for d in shape[:-1]:
        T *= d
    return shape[-1] % 128 == 0 and T % 8 == 0 and T > 0


def ln_kernel_enabled(use_kernels: bool, shape) -> bool:
    """Engage the fused LayerNorm?  Off unless MMDTI_PALLAS_LN=1, and then
    only for a module built with use_kernels on a supported shape."""
    if os.environ.get("MMDTI_PALLAS_LN", "0") != "1":
        return False
    return bool(use_kernels) and layer_norm_supported(shape)


def _stats(xf: torch.Tensor, eps: float):
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return mu, torch.rsqrt(var + eps)


def layer_norm_plain(x, scale, bias, eps: float, out_dtype=None) -> torch.Tensor:
    """Plain version of the forward kernel (models/layers.py's formula);
    differentiable through autograd."""
    od = x.dtype if out_dtype is None else out_dtype
    xf = x.float()
    mu, rstd = _stats(xf, eps)
    return ((xf - mu) * (rstd * scale) + bias).to(od)


def layer_norm_bwd_plain(x, scale, gy, eps: float):
    """Plain version of the backward kernel, pallas_ln.py::_bwd_kernel's
    arithmetic on x [T, E], gy [T, E]: (dx in x's dtype, dscale [E],
    dbias [E] fp32)."""
    xf, g = x.float(), gy.float()
    mu, rstd = _stats(xf, eps)
    xhat = (xf - mu) * rstd
    wdy = g * scale.float()
    c1 = (wdy * xhat).mean(dim=-1, keepdim=True)
    c2 = wdy.mean(dim=-1, keepdim=True)
    dx = ((wdy - xhat * c1 - c2) * rstd).to(x.dtype)
    return dx, (g * xhat).sum(dim=0), g.sum(dim=0)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check(named, dev, E):
    for n, t in named:
        if t.device != dev:
            raise ValueError(f"{n} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if n not in ("scale", "bias") and t.data_ptr() % 16:
            raise ValueError(f"{n} must be 16-byte aligned")
    for n, t in named:
        if n in ("scale", "bias") and (t.dtype != torch.float32 or t.shape != (E,)):
            raise ValueError(f"{n} must be float32 [{E}], got {t.dtype} {tuple(t.shape)}")
        elif n not in ("scale", "bias") and t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"{n} must be float32 or bfloat16, got {t.dtype}")


def _rows(x):
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [T, E], got {tuple(x.shape)}")
    T, E = x.shape
    if T < 1 or E % 8 or not 0 < E <= MAX_E:
        raise ValueError(f"layer_norm kernel takes T >= 1 and E % 8 == 0, E <= {MAX_E}; "
                         f"got T={T}, E={E}")
    return T, E


def layer_norm_cuda(x, scale, bias, eps: float, out_dtype) -> torch.Tensor:
    """Launch csrc/layer_norm.cu's forward on x [T, E] -> y [T, E] in
    out_dtype."""
    T, E = _rows(x)
    _check((("x", x), ("scale", scale), ("bias", bias)), x.device, E)
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    y = torch.empty((T, E), dtype=out_dtype, device=x.device)
    rc = _build.load("layer_norm").mmdti_layer_norm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), T, E, float(eps),
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, f"layer_norm (T={T}, E={E})")
    layer_norm_cuda.launches += 1
    return y


layer_norm_cuda.launches = 0


def backward_blocks(T: int, device) -> int:
    """Blocks of the backward's row launch: one row per warp up to two
    blocks per SM, then each warp walks several rows."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-T // ROWS_PER_BLOCK), 2 * sms))


def layer_norm_bwd_cuda(x, scale, gy, eps: float):
    """Launch csrc/layer_norm.cu's backward (the row launch, then the
    ordered reduction of its per-block partial rows).  Returns the
    gradients of layer_norm_bwd_plain."""
    T, E = _rows(x)
    _check((("x", x), ("scale", scale), ("gy", gy)), x.device, E)
    if gy.shape != x.shape:
        raise ValueError(f"gy {tuple(gy.shape)} must match x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    nblocks = backward_blocks(T, x.device)
    partials = torch.empty((nblocks, 2 * E), dtype=torch.float32, device=x.device)
    rc = _build.load("layer_norm").mmdti_layer_norm_bwd(
        x.data_ptr(), scale.data_ptr(), gy.data_ptr(), dx.data_ptr(), partials.data_ptr(),
        nblocks, T, E, float(eps), int(x.dtype == torch.bfloat16),
        int(gy.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, f"layer_norm_bwd (T={T}, E={E})")
    layer_norm_bwd_cuda.launches += 1
    grads = layer_norm_bwd_reduce_cuda(partials)
    return dx, grads[:E], grads[E:]


layer_norm_bwd_cuda.launches = 0


def layer_norm_bwd_reduce_cuda(partials: torch.Tensor) -> torch.Tensor:
    """Launch the backward's second kernel: the column sums of partials
    [nblocks, 2E] in block order -> [2E] (dscale then dbias)."""
    nblocks, width = partials.shape
    out = torch.empty(width, dtype=torch.float32, device=partials.device)
    rc = _build.load("layer_norm").mmdti_layer_norm_bwd_reduce(
        partials.data_ptr(), out.data_ptr(), nblocks, width // 2,
        torch.cuda.current_stream(partials.device).cuda_stream,
    )
    _build.check(rc, f"layer_norm_bwd_reduce (blocks={nblocks}, E={width // 2})")
    layer_norm_bwd_reduce_cuda.launches += 1
    return out


layer_norm_bwd_reduce_cuda.launches = 0


class LayerNormFn(torch.autograd.Function):
    """The kernel pair as one differentiable op: apply(x2d [T,E], scale,
    bias, eps, out_dtype) -> y [T,E] in out_dtype.  Saves x and scale."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        if x.device.type == "cpu":
            y = layer_norm_plain(x, scale, bias, eps, out_dtype)
        else:
            y = layer_norm_cuda(x, scale, bias, eps, out_dtype)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, gy):
        x, scale = ctx.saved_tensors
        bwd = layer_norm_bwd_plain if x.device.type == "cpu" else layer_norm_bwd_cuda
        dx, dscale, dbias = bwd(x, scale, gy.contiguous(), ctx.eps)
        return dx, dscale, dbias, None, None


def layer_norm_fused(x, scale, bias, epsilon: float = 1e-5, out_dtype=None) -> torch.Tensor:
    """Fused LayerNorm over the last axis of x [..., E] with fp32 scale and
    bias [E]; the result in ``out_dtype`` (default x's dtype).  The caller
    checks ``layer_norm_supported``."""
    if not layer_norm_supported(x.shape):
        raise ValueError(f"fused layer norm unsupported at shape {tuple(x.shape)}; "
                         "check layer_norm_supported() and use the plain path")
    od = x.dtype if out_dtype is None else out_dtype
    E = x.shape[-1]
    y = LayerNormFn.apply(x.reshape(-1, E).contiguous(), scale.float().contiguous(),
                          bias.float().contiguous(), float(epsilon), od)
    return y.reshape(x.shape)
