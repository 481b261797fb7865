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
csrc/layer_norm.cu: persistent blocks sized to the card, rows prefetched
into a shared-memory ring, and a backward that gives dx, dscale and dbias
in one deterministic launch (clusters of CLUSTER blocks, an integer ticket
per cluster rank for the last block; the scratch is allocated once per
device, width and grid).  A CPU tensor runs the plain versions below, a
CUDA tensor launches the kernels or raises.  The launchers count their
launches in ``layer_norm_cuda.launches`` and
``layer_norm_bwd_cuda.launches`` (one launch a backward).

The gate takes the JAX package's shape rule (pallas_ln.py:73-100:
E % 128 == 0 and T % 8 == 0) and reads ``MMDTI_PALLAS_LN`` at every call.
On a CUDA device the kernels are the default: unset or ``1`` engages them,
``0`` keeps the plain path.  Elsewhere, and where no device is given, the
JAX package's opt-in holds: only ``1`` engages them, so every CPU path
stays the JAX gate's.
"""

from __future__ import annotations

import ctypes
import os

import torch

from mmdti_tpu_torch.ops import _build

MAX_E = 1024            # widest row csrc/layer_norm.cu takes
WARPS = 8               # kWarps in csrc/layer_norm.cu: warps per block, one row each at a time
CLUSTER = 8             # kCluster in csrc/layer_norm.cu: blocks per backward cluster
MIN_ROWS_PER_WARP = 2   # rows a backward warp takes at least, where T allows


def layer_norm_supported(shape) -> bool:
    """True when the kernels take this activation shape (pallas_ln.py's
    rule: rank >= 2, E % 128 == 0, T % 8 == 0, T > 0)."""
    if len(shape) < 2:
        return False
    T = 1
    for d in shape[:-1]:
        T *= d
    return shape[-1] % 128 == 0 and T % 8 == 0 and T > 0


def ln_kernels_on(device=None) -> bool:
    """The LayerNorm kernels' setting in force on ``device``, read now:
    MMDTI_PALLAS_LN=1 on, any other value off, and unset on for a CUDA
    device and off elsewhere or without a device (the JAX gate).  A CUDA
    graph keeps what it read at capture, so train/steps.py and
    api/serve_api.py key their graphs by this."""
    env = os.environ.get("MMDTI_PALLAS_LN")
    if env is None:
        return device is not None and torch.device(device).type == "cuda"
    return env == "1"


def ln_kernel_enabled(use_kernels: bool, shape, device=None) -> bool:
    """Engage the fused LayerNorm?  Where ``ln_kernels_on(device)`` holds,
    for a module built with use_kernels on a supported shape.  Every call
    in the program names its device; without one the answer is the JAX
    gate's, the form tests/test_torch_ln.py holds against it."""
    if not ln_kernels_on(device):
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
        if n in ("scale", "bias"):
            if t.dtype != torch.float32 or t.shape != (E,):
                raise ValueError(f"{n} must be float32 [{E}], got {t.dtype} {tuple(t.shape)}")
        elif t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"{n} must be float32 or bfloat16, got {t.dtype}")
        elif t.data_ptr() % 16:
            raise ValueError(f"{n} must be 16-byte aligned")


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


def forward_grid(T: int, resident: int) -> int:
    """Blocks of the forward: one row per warp while the card holds them
    all at once, else the resident blocks, each warp walking several rows."""
    return max(1, min(-(-T // WARPS), resident))


def backward_grid(T: int, resident: int) -> int:
    """Blocks of the backward, a multiple of CLUSTER: at least
    MIN_ROWS_PER_WARP rows per warp (so its dscale/dbias registers sum
    rows, and the cluster rows stay few), at most the resident blocks."""
    want = -(-T // (WARPS * MIN_ROWS_PER_WARP))
    clusters = min(-(-want // CLUSTER), max(1, resident // CLUSTER))
    return clusters * CLUSTER


_RESIDENT = {}   # (device index, backward, E, x bf16, y bf16) -> resident blocks
_SCRATCH = {}    # (device index, E, grid) -> (cluster rows, tickets)


def _resident(dev, backward: int, E: int, xb: int, yb: int) -> int:
    """Blocks the card runs at once for this kernel configuration, asked of
    the CUDA runtime once per device and configuration (which also raises
    the kernel's shared-memory limit before its first launch)."""
    key = (dev.index, backward, E, xb, yb)
    got = _RESIDENT.get(key)
    if got is None:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = _build.load("layer_norm").mmdti_layer_norm_resident(backward, E, xb, yb,
                                                                     ctypes.byref(blocks))
        _build.check(rc, f"layer_norm occupancy (backward={backward}, E={E})")
        got = _RESIDENT[key] = blocks.value
    return got


def _scratch(dev, E: int, grid: int):
    """The backward's cluster rows [grid / CLUSTER, 2E] fp32 and its tickets
    (CLUSTER int32, one a cluster rank, 0 between launches: the last block
    of a rank sets its ticket back), allocated once per device, width and
    grid.  Launches that share them must be ordered on one stream, as the
    model's are."""
    key = (dev.index, E, grid)
    got = _SCRATCH.get(key)
    if got is None:
        got = _SCRATCH[key] = (
            torch.empty((grid // CLUSTER, 2 * E), dtype=torch.float32, device=dev),
            torch.zeros(CLUSTER, dtype=torch.int32, device=dev))
    return got


def _stream(dev) -> int:
    """The current CUDA stream of dev as an int, without building a
    torch.cuda.Stream object (a launch pays for that on the host)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def layer_norm_cuda(x, scale, bias, eps: float, out_dtype) -> torch.Tensor:
    """Launch csrc/layer_norm.cu's forward on x [T, E] -> y [T, E] in
    out_dtype."""
    T, E = _rows(x)
    dev = x.device
    _check((("x", x), ("scale", scale), ("bias", bias)), dev, E)
    if out_dtype not in _KERNEL_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    xb, yb = int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16)
    grid = forward_grid(T, _resident(dev, 0, E, xb, yb))
    y = torch.empty((T, E), dtype=out_dtype, device=dev)
    rc = _build.load("layer_norm").mmdti_layer_norm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), T, E, float(eps), xb, yb,
        grid, _stream(dev))
    if rc:
        _build.check(rc, f"layer_norm (T={T}, E={E})")
    layer_norm_cuda.launches += 1
    return y


layer_norm_cuda.launches = 0


def layer_norm_bwd_cuda(x, scale, gy, eps: float):
    """Launch csrc/layer_norm.cu's backward, one launch for dx, dscale and
    dbias.  Returns the gradients of layer_norm_bwd_plain."""
    T, E = _rows(x)
    dev = x.device
    _check((("x", x), ("scale", scale), ("gy", gy)), dev, E)
    if gy.shape != x.shape:
        raise ValueError(f"gy {tuple(gy.shape)} must match x {tuple(x.shape)}")
    xb, yb = int(x.dtype == torch.bfloat16), int(gy.dtype == torch.bfloat16)
    grid = backward_grid(T, _resident(dev, 1, E, xb, yb))
    rows, tickets = _scratch(dev, E, grid)
    dx = torch.empty_like(x)
    grads = torch.empty(2 * E, dtype=torch.float32, device=dev)
    rc = _build.load("layer_norm").mmdti_layer_norm_bwd(
        x.data_ptr(), scale.data_ptr(), gy.data_ptr(), dx.data_ptr(), grads.data_ptr(),
        rows.data_ptr(), tickets.data_ptr(), T, E, float(eps), xb, yb, grid, _stream(dev))
    if rc:
        _build.check(rc, f"layer_norm_bwd (T={T}, E={E})")
    layer_norm_bwd_cuda.launches += 1
    return dx, grads[:E], grads[E:]


layer_norm_bwd_cuda.launches = 0


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
