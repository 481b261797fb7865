"""Hand-written Hopper kernel for the fused Gaussian pair-bias projection,
with its plain PyTorch version.

``gbf_pair_bias_fused`` replaces the TPU kernel
mmdti_tpu/ops/pallas_gbf.py::_fwd_kernel.  From the per-pair affine
distance u = mul*dist + bias [B,N,N] it computes

    G    = exp(-((u - mean_k)/std_k)^2 / 2) / (sqrt(2*pi)*std_k)   [.., K]
    bias = W2 act(W1 G + b1) + b2                                  [.., H]

(std = |stds| + 1e-5, pi = 3.14159 as in the reference) and returns the
attention bias directly as [B,H,N,N] in the pair dtype, with -inf at padded
keys: the encoder's padding merge is fused in.  The GEMM operands are
rounded to the compute dtype and accumulated in fp32.  CUDA source:
csrc/gbf_proj.cu; the launcher counts its launches in
``gbf_pair_bias_cuda.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmdti_tpu_torch.ops import _build

SQRT_2PI = (2 * 3.14159) ** 0.5  # reference constant (models/gaussian.py)
ACTIVATIONS = {"gelu_tanh": 0, "gelu": 1}
WIDTHS = ((128, 64), (128, 96))  # (hidden Kh, heads H) instantiated in csrc/gbf_proj.cu


def gaussian_pdf(x, mean, std):
    return torch.exp(-0.5 * (((x - mean) / std) ** 2)) / (SQRT_2PI * std)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu_tanh":
        return torch.nn.functional.gelu(x, approximate="tanh")
    if name == "gelu":
        return torch.nn.functional.gelu(x)
    raise ValueError(f"unsupported activation for the fused gbf kernel: {name}")


def gbf_pair_bias_plain(u, means, stds, w1, b1, w2, b2,
                        padding_mask: Optional[torch.Tensor] = None,
                        activation: str = "gelu_tanh", pair_dtype=torch.float32,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the fused kernel.  w1 [Kh,K], w2 [H,Kh] in
    nn.Linear layout; padding_mask [B,N] bool (True at pads) or None.
    Returns [B,H,N,N] in pair_dtype."""
    std = stds.float().abs() + 1e-5

    def rnd(t):  # round to the compute dtype, keep fp32 arithmetic
        return t.to(compute_dtype).float()

    g = gaussian_pdf(u.float()[..., None], means.float(), std)       # [B,N,N,K]
    h = _act(activation, torch.matmul(rnd(g), rnd(w1).t()) + b1.float())
    o = torch.matmul(rnd(h), rnd(w2).t()) + b2.float()                # [B,N,N,H]
    o = o.permute(0, 3, 1, 2)
    if padding_mask is not None:
        o = o.masked_fill(padding_mask[:, None, None, :], float("-inf"))
    return o.to(pair_dtype)


def gbf_pair_bias_cuda(u, means, std, w1, b1, w2, b2, padding_mask, activation: str,
                       pair_dtype, compute_dtype) -> torch.Tensor:
    """Launch csrc/gbf_proj.cu.  ``std`` is already |stds| + 1e-5; every
    float input is fp32 and contiguous; padding_mask is bool [B,N] or None."""
    tensors = [u, means, std, w1, b1, w2, b2]
    names = ["u", "means", "std", "w1", "b1", "w2", "b2"]
    if padding_mask is not None:
        tensors.append(padding_mask)
        names.append("padding_mask")
    dev = u.device
    for t, n in zip(tensors, names):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{n} must be a CUDA tensor on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
        if n != "padding_mask" and t.dtype != torch.float32:
            raise TypeError(f"{n} must be float32, got {t.dtype}")
    B, N, N2 = u.shape
    Kh, K = w1.shape
    H = w2.shape[0]
    if (N2 != N or means.shape != (K,) or std.shape != (K,) or b1.shape != (Kh,)
            or w2.shape != (H, Kh) or b2.shape != (H,)):
        raise ValueError(
            f"gbf shapes: u {tuple(u.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}"
        )
    if (Kh, H) not in WIDTHS:
        raise ValueError(f"gbf kernel takes (hidden, heads) in {WIDTHS}, got {(Kh, H)}")
    if padding_mask is not None and (padding_mask.shape != (B, N)
                                     or padding_mask.dtype != torch.bool):
        raise ValueError("padding_mask must be bool [B, N]")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation for the fused gbf kernel: {activation}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    if pair_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pair_dtype must be float32 or bfloat16, got {pair_dtype}")
    out = torch.empty((B, H, N, N), dtype=pair_dtype, device=dev)
    lib = _build.load("gbf_proj")
    rc = lib.mmdti_gbf_proj_fwd(
        u.data_ptr(), means.data_ptr(), std.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(),
        None if padding_mask is None else padding_mask.data_ptr(), out.data_ptr(),
        B, N, K, Kh, H, int(compute_dtype == torch.bfloat16),
        int(pair_dtype == torch.bfloat16), ACTIVATIONS[activation], SQRT_2PI,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, f"gbf_proj (B={B}, N={N}, K={K}, Kh={Kh}, H={H})")
    gbf_pair_bias_cuda.launches += 1
    return out


gbf_pair_bias_cuda.launches = 0


def gbf_pair_bias_fused(u, means, stds, w1, b1, w2, b2,
                        padding_mask: Optional[torch.Tensor] = None,
                        activation: str = "gelu_tanh", pair_dtype=torch.float32,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """Fused Gaussian expansion + gbf_proj MLP -> [B,H,N,N] pair bias with
    -inf at padded keys: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if u.device.type == "cpu":
        return gbf_pair_bias_plain(u, means, stds, w1, b1, w2, b2, padding_mask,
                                   activation, pair_dtype, compute_dtype)
    f32 = [t.float().contiguous() for t in (u, means, stds.float().abs() + 1e-5,
                                            w1, b1, w2, b2)]
    pad = None if padding_mask is None else padding_mask.bool().contiguous()
    return gbf_pair_bias_cuda(*f32, pad, activation, pair_dtype, compute_dtype)
