"""The products of the plain reference, in float32 or in the control's fp8.

``Numerics("float32")`` is the reference: every product in float32 with
TF32 off.  ``Numerics("fp8")`` is the correctness control, the precision
below the bfloat16 the configurations state: each operand of every product
(the dense layers and the attention's two products) is rounded to
float8_e4m3fn with one scale per tensor (its absolute maximum onto 448),
and in the backward the incoming gradient to float8_e5m2 (onto 57344), the
usual fp8 training recipe; the products then accumulate in float32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to an fp8 format with one scale per tensor, back in float32."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).clamp(-top, top).to(dtype).float() / scale


def e4m3(x):
    return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)


def e5m2(x):
    return _fp8(x, torch.float8_e5m2, E5M2_MAX)


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands in e4m3; the backward's products take the
    gradient in e5m2 against the saved e4m3 operands."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = e4m3(a), e4m3(b)
        ctx.save_for_backward(aq, bq)
        return torch.matmul(aq, bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = e5m2(g)
        ga = torch.matmul(gq, bq.transpose(-1, -2))
        gb = torch.matmul(aq.transpose(-1, -2), gq)
        # undo the broadcast of a batched operand
        while ga.dim() > aq.dim():
            ga = ga.sum(0)
        while gb.dim() > bq.dim():
            gb = gb.sum(0)
        return ga, gb


class Numerics:
    """The precision every product of the reference takes."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}: expected 'float32' or 'fp8'")
        self.precision = precision

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8MatMul.apply(a.float(), b.float())
        return torch.matmul(a.float(), b.float())

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        """x @ w.T + b, as torch.nn.functional.linear."""
        y = self.matmul(x, w.t())
        return y if b is None else y + b.float()


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 inside the block: TF32 off for matmul
    and cuDNN, the settings restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
