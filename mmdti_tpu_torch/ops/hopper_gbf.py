"""Hand-written Hopper kernels for the fused Gaussian pair-bias projection,
forward and backward, with their plain PyTorch versions.

``gbf_pair_bias_fused`` replaces the TPU kernels
mmdti_tpu/ops/pallas_gbf.py::_fwd_kernel and ``_bwd_kernel``.  From the
per-pair affine distance u = mul*dist + bias [B,N,N] it computes

    G    = exp(-((u - mean_k)/std_k)^2 / 2) / (sqrt(2*pi)*std_k)   [.., K]
    bias = W2 act(W1 G + b1) + b2                                  [.., H]

(std = |stds| + 1e-5, pi = 3.14159 as in the reference) and returns the
attention bias directly as [B,H,N,N] in the pair dtype, with -inf at padded
keys: the encoder's padding merge is fused in, and the backward zeroes the
cotangent there (the merge passes no gradient).  The GEMM operands are
rounded to the compute dtype and accumulated in fp32.  ``std`` is formed
outside the differentiable op, so autograd applies the sign of ``stds``.
CUDA source: csrc/gbf_proj.cu, two routes chosen by ``gbf_route``: "mma"
(bf16 compute at K = Kh = 128: every GEMM on the tensor cores) and "fma"
(the FMA-unit kernels, fp32 compute above all).  The launchers count their
launches in ``gbf_pair_bias_cuda.launches`` and
``gbf_pair_bias_bwd_cuda.launches``, and per route in their ``.routes``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mmdti_tpu_torch.ops import _build

SQRT_2PI = (2 * 3.14159) ** 0.5  # reference constant (models/gaussian.py)
ACTIVATIONS = {"gelu_tanh": 0, "gelu": 1}
# (hidden Kh, heads H) instantiated in csrc/gbf_proj.cu: a whole flagship or
# scale-arch layer's heads (64, 96) and a tensor-parallel rank's share of
# them (64/4, 64/2, 96/2)
HEADS = (16, 32, 48, 64, 96)
WIDTHS = tuple((128, h) for h in HEADS)
BWD_K = 128                       # the backward kernels take K = Kh = 128
ROUTES = ("mma", "fma")


def gbf_route(compute_dtype, K: int, Kh: int, H: int) -> str:
    """The kernel route of a gbf call: "mma" (tensor-core kernels) for bf16
    compute at K = Kh = 128 and H in HEADS, "fma" (FMA-unit kernels) for
    everything else."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if compute_dtype == torch.bfloat16 and K == Kh == BWD_K and H in HEADS:
        return "mma"
    return "fma"


def gaussian_pdf(x, mean, std):
    return torch.exp(-0.5 * (((x - mean) / std) ** 2)) / (SQRT_2PI * std)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu_tanh":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if name == "gelu":
        return torch.nn.functional.gelu(x)
    raise ValueError(f"unsupported activation for the fused gbf kernel: {name}")


def _act_grad(name: str, x: torch.Tensor) -> torch.Tensor:
    """d act / dx, the formulas of pallas_gbf.py::_act_and_grad."""
    if name == "gelu_tanh":
        a, b = 0.7978845608028654, 0.044715
        t = torch.tanh(a * (x + b * x * x * x))
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * a * (1.0 + 3.0 * b * x * x)
    if name == "gelu":
        phi = 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
        return phi + x * (1.0 / math.sqrt(2.0 * math.pi)) * torch.exp(-0.5 * x * x)
    raise ValueError(f"unsupported activation for the fused gbf kernel: {name}")


def _rounder(compute_dtype):
    return lambda t: t.to(compute_dtype).float()


def _forward_plain(u, means, std, w1, b1, w2, b2, padding_mask, activation, pair_dtype,
                   compute_dtype):
    rnd = _rounder(compute_dtype)
    g = gaussian_pdf(u.float()[..., None], means.float(), std.float())  # [B,N,N,K]
    h = _act(activation, torch.matmul(rnd(g), rnd(w1).t()) + b1.float())
    o = torch.matmul(rnd(h), rnd(w2).t()) + b2.float()                   # [B,N,N,H]
    o = o.permute(0, 3, 1, 2)
    if padding_mask is not None:
        o = o.masked_fill(padding_mask[:, None, None, :], float("-inf"))
    return o.to(pair_dtype)


def gbf_pair_bias_plain(u, means, stds, w1, b1, w2, b2,
                        padding_mask: Optional[torch.Tensor] = None,
                        activation: str = "gelu_tanh", pair_dtype=torch.float32,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the fused forward kernel.  w1 [Kh,K], w2 [H,Kh] in
    nn.Linear layout; padding_mask [B,N] bool (True at pads) or None.
    Returns [B,H,N,N] in pair_dtype."""
    return _forward_plain(u, means, stds.float().abs() + 1e-5, w1, b1, w2, b2, padding_mask,
                          activation, pair_dtype, compute_dtype)


def gbf_pair_bias_bwd_plain(u, means, std, w1, b1, w2, g,
                            padding_mask: Optional[torch.Tensor] = None,
                            activation: str = "gelu_tanh", compute_dtype=torch.float32):
    """Plain version of the fused backward kernel, rounding where
    pallas_gbf.py::_bwd_kernel rounds.  ``std`` is |stds| + 1e-5; g is the
    cotangent of the [B,H,N,N] output, zeroed here at padded keys.  Returns
    (du [B,N,N], dmeans [K], dstd [K], dw1 [Kh,K], db1 [Kh], dw2 [H,Kh],
    db2 [H]), fp32."""
    rnd = _rounder(compute_dtype)
    std = std.float()
    go = g.float()
    if padding_mask is not None:
        go = go.masked_fill(padding_mask[:, None, None, :], 0.0)
    go = go.permute(0, 2, 3, 1).reshape(-1, go.shape[1])                # [P,H]
    z = (u.float().reshape(-1, 1) - means.float()) / std                # [P,K]
    gk = torch.exp(-0.5 * z * z) / (SQRT_2PI * std)
    h_pre = torch.matmul(rnd(gk), rnd(w1).t()) + b1.float()             # [P,Kh]
    h = _act(activation, h_pre)
    db2 = go.sum(dim=0)
    dw2 = torch.matmul(rnd(go).t(), rnd(h))                             # [H,Kh]
    dpre = torch.matmul(rnd(go), rnd(w2)) * _act_grad(activation, h_pre)
    db1 = dpre.sum(dim=0)
    dw1 = torch.matmul(rnd(dpre).t(), rnd(gk))                          # [Kh,K]
    dgz = torch.matmul(rnd(dpre), rnd(w1)) * gk                         # [P,K]
    zs = z / std
    dmeans = (dgz * zs).sum(dim=0)
    dstd = (dgz * (z * z - 1.0) / std).sum(dim=0)
    du = (dgz * -zs).sum(dim=1).reshape(u.shape)
    return du, dmeans, dstd, dw1, db1, dw2, db2


def _check_cuda_inputs(named, dev):
    for n, t in named:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{n} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if n != "padding_mask" and n != "g" and t.dtype != torch.float32:
            raise TypeError(f"{n} must be float32, got {t.dtype}")


def _check_options(padding_mask, B, N, activation, pair_dtype, compute_dtype):
    if padding_mask is not None and (padding_mask.shape != (B, N)
                                     or padding_mask.dtype != torch.bool):
        raise ValueError("padding_mask must be bool [B, N]")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation for the fused gbf kernel: {activation}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if pair_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pair_dtype must be float32 or bfloat16, got {pair_dtype}")


def _widths(u, means, std, w1, b1, w2):
    B, N, N2 = u.shape
    Kh, K = w1.shape
    H = w2.shape[0]
    if (N2 != N or means.shape != (K,) or std.shape != (K,) or b1.shape != (Kh,)
            or w2.shape != (H, Kh)):
        raise ValueError(
            f"gbf shapes: u {tuple(u.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}"
        )
    if (Kh, H) not in WIDTHS:
        raise ValueError(f"gbf kernel takes (hidden, heads) in {WIDTHS}, got {(Kh, H)}")
    return B, N, K, Kh, H


def gbf_pair_bias_cuda(u, means, std, w1, b1, w2, b2, padding_mask, activation: str,
                       pair_dtype, compute_dtype) -> torch.Tensor:
    """Launch csrc/gbf_proj.cu's forward.  ``std`` is already |stds| + 1e-5;
    every float input is fp32 and contiguous; padding_mask is bool [B,N] or
    None."""
    dev = u.device
    _check_cuda_inputs((("u", u), ("means", means), ("std", std), ("w1", w1), ("b1", b1),
                        ("w2", w2), ("b2", b2), ("padding_mask", padding_mask)), dev)
    B, N, K, Kh, H = _widths(u, means, std, w1, b1, w2)
    if b2.shape != (H,):
        raise ValueError(f"gbf shapes: b2 {tuple(b2.shape)} for H={H}")
    _check_options(padding_mask, B, N, activation, pair_dtype, compute_dtype)
    route = gbf_route(compute_dtype, K, Kh, H)
    out = torch.empty((B, H, N, N), dtype=pair_dtype, device=dev)
    lib = _build.load("gbf_proj")
    head = (u.data_ptr(), means.data_ptr(), std.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(),
            None if padding_mask is None else padding_mask.data_ptr(), out.data_ptr())
    tail = (int(pair_dtype == torch.bfloat16), ACTIVATIONS[activation], SQRT_2PI,
            torch.cuda.current_stream(dev).cuda_stream)
    if route == "mma":
        rc = lib.mmdti_gbf_proj_mma_fwd(*head, B, N, H, *tail)
    else:
        rc = lib.mmdti_gbf_proj_fwd(*head, B, N, K, Kh, H, int(compute_dtype == torch.bfloat16),
                                    *tail)
    _build.check(rc, f"gbf_proj {route} (B={B}, N={N}, K={K}, Kh={Kh}, H={H})")
    gbf_pair_bias_cuda.launches += 1
    gbf_pair_bias_cuda.routes[route] += 1
    return out


gbf_pair_bias_cuda.launches = 0
gbf_pair_bias_cuda.routes = dict.fromkeys(ROUTES, 0)


def gbf_pair_bias_bwd_cuda(u, means, std, w1, b1, w2, g, padding_mask, activation: str,
                           compute_dtype):
    """Launch csrc/gbf_proj.cu's backward (a persistent kernel and a
    fixed-order reduction of its per-block partial sums).  Inputs as the
    forward's; g [B,H,N,N] in the pair dtype.  Returns the gradients of
    gbf_pair_bias_bwd_plain."""
    dev = u.device
    _check_cuda_inputs((("u", u), ("means", means), ("std", std), ("w1", w1), ("b1", b1),
                        ("w2", w2), ("g", g), ("padding_mask", padding_mask)), dev)
    B, N, K, Kh, H = _widths(u, means, std, w1, b1, w2)
    if K != BWD_K or Kh != BWD_K:
        raise ValueError(f"gbf backward kernel takes K = Kh = {BWD_K}, got K={K}, Kh={Kh}")
    if g.shape != (B, H, N, N):
        raise ValueError(f"gbf backward: g {tuple(g.shape)}, expected {(B, H, N, N)}")
    _check_options(padding_mask, B, N, activation, g.dtype, compute_dtype)
    du = torch.empty_like(u)
    sizes = (Kh * K, H * Kh, Kh, H, K, K)
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    max_blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partials = torch.empty(max_blocks * sum(sizes), dtype=torch.float32, device=dev)
    route = gbf_route(compute_dtype, K, Kh, H)
    lib = _build.load("gbf_proj")
    head = (u.data_ptr(), means.data_ptr(), std.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), None if padding_mask is None else padding_mask.data_ptr(),
            g.data_ptr(), du.data_ptr(), grads.data_ptr(), partials.data_ptr(), max_blocks)
    tail = (int(g.dtype == torch.bfloat16), ACTIVATIONS[activation], SQRT_2PI,
            torch.cuda.current_stream(dev).cuda_stream)
    if route == "mma":
        rc = lib.mmdti_gbf_proj_mma_bwd(*head, B, N, H, *tail)
    else:
        rc = lib.mmdti_gbf_proj_bwd(*head, B, N, K, Kh, H, int(compute_dtype == torch.bfloat16),
                                    *tail)
    _build.check(rc, f"gbf_proj_bwd {route} (B={B}, N={N}, K={K}, Kh={Kh}, H={H})")
    gbf_pair_bias_bwd_cuda.launches += 1
    gbf_pair_bias_bwd_cuda.routes[route] += 1
    dw1, dw2, db1, db2, dmeans, dstd = torch.split(grads, sizes)
    return du, dmeans, dstd, dw1.view(Kh, K), db1, dw2.view(H, Kh), db2


gbf_pair_bias_bwd_cuda.launches = 0
gbf_pair_bias_bwd_cuda.routes = dict.fromkeys(ROUTES, 0)


class GbfPairBias(torch.autograd.Function):
    """The fused gbf kernel pair as one differentiable op: apply(u, means,
    std, w1, b1, w2, b2, padding_mask, activation, pair_dtype, compute_dtype)
    -> [B,H,N,N] bias in pair_dtype (std = |stds| + 1e-5, formed outside)."""

    @staticmethod
    def forward(ctx, u, means, std, w1, b1, w2, b2, padding_mask, activation, pair_dtype,
                compute_dtype):
        if u.device.type == "cpu":
            out = _forward_plain(u, means, std, w1, b1, w2, b2, padding_mask, activation,
                                 pair_dtype, compute_dtype)
        else:
            out = gbf_pair_bias_cuda(u, means, std, w1, b1, w2, b2, padding_mask, activation,
                                     pair_dtype, compute_dtype)
        ctx.save_for_backward(u, means, std, w1, b1, w2, padding_mask)
        ctx.activation, ctx.compute_dtype = activation, compute_dtype
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return (None,) * 11
        u, means, std, w1, b1, w2, padding_mask = ctx.saved_tensors
        bwd = gbf_pair_bias_bwd_plain if u.device.type == "cpu" else gbf_pair_bias_bwd_cuda
        grads = bwd(u, means, std, w1, b1, w2, g.contiguous(), padding_mask, ctx.activation,
                    ctx.compute_dtype)
        return (*grads, None, None, None, None)


def gbf_pair_bias_fused(u, means, stds, w1, b1, w2, b2,
                        padding_mask: Optional[torch.Tensor] = None,
                        activation: str = "gelu_tanh", pair_dtype=torch.float32,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """Fused Gaussian expansion + gbf_proj MLP -> [B,H,N,N] pair bias with
    -inf at padded keys, differentiable: the kernels for CUDA tensors, the
    plain versions for CPU tensors."""
    std = stds.float().abs() + 1e-5
    f32 = [t.float().contiguous() for t in (u, means, std, w1, b1, w2, b2)]
    pad = None if padding_mask is None else padding_mask.bool().contiguous()
    return GbfPairBias.apply(*f32, pad, activation, pair_dtype, compute_dtype)
