"""The attention-dropout keep mask, as a pure function of its coordinates.

The TPU kernels seed the on-core PRNG once per grid program
(mmdti_tpu/ops/pallas_attention.py::_keep_mask), so their mask depends on
the tiling.  The port's mask depends on nothing but

    keep(seed, b, h, i, j) = bits(seed, b*H + h, i*Nk + j) >= threshold(rate)

so the forward kernel, the backward kernel (which replays it) and the plain
versions below compute the same bits whatever their tiling.  ``bits`` is a
counter-based hash built from murmur3's 32-bit finalizer:

    key  = fmix32(seed ^ fmix32(bh + 0x9E3779B9))
    bits = fmix32(key ^ fmix32(ij + 0x7F4A7C15))          (all mod 2^32)

The device version is csrc/dropout.cuh.  Here the arithmetic runs in int64
with every value kept in [0, 2^32): a 32x32-bit multiply is split into
16-bit halves so no product overflows int64.  A dropped probability is 0
and a kept one is scaled by 1/(1 - rate), as in the TPU kernels
(``_softmax_factored``).
"""

from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF
_BH_SALT = 0x9E3779B9
_IJ_SALT = 0x7F4A7C15


def threshold(rate: float) -> int:
    """uint32 cut below which a draw is dropped (pallas_attention.py:64)."""
    return min(int(rate * 4294967296.0), 4294967295)


def keep_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_mask(seed: int, rate: float, B: int, H: int, Nq: int, Nk: int,
              heads: Optional[slice] = None, device=None) -> torch.Tensor:
    """bool [B, h, Nq, Nk]: True where a probability is kept, for the heads
    ``heads`` (default all) of a call with H heads.  Equal, entry by entry,
    to the mask the CUDA kernels draw for the same seed.  The int64 work
    runs a few heads at a time, so its temporaries stay a few times the size
    of one head's [B, Nq, Nk] slice."""
    hs = list(range(H)[heads] if heads is not None else range(H))
    cut = threshold(rate)
    ij = torch.arange(Nq * Nk, dtype=torch.int64, device=device).reshape(Nq, Nk)
    fij = fmix32((ij + _IJ_SALT) & _M32)                              # [Nq, Nk]
    b = torch.arange(B, dtype=torch.int64, device=device)[:, None]
    out = torch.empty((B, len(hs), Nq, Nk), dtype=torch.bool, device=device)
    step = max(1, (1 << 22) // max(1, B * Nq * Nk))
    for c0 in range(0, len(hs), step):
        h = torch.tensor(hs[c0:c0 + step], dtype=torch.int64, device=device)[None, :]
        key = fmix32((int(seed) & _M32) ^ fmix32((b * H + h + _BH_SALT) & _M32))
        out[:, c0:c0 + step] = fmix32(key[:, :, None, None] ^ fij[None, None]) >= cut
    return out
