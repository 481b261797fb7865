"""Ragged->dense batch padding utilities (numpy).

Numpy re-design of the reference torch padding helpers
(reference utils/util.py:7-105): pad_1d_tokens, pad_2d (square pair
matrices), pad_coords (N x 3), with pad-to-length / pad-to-multiple options.
TPU-specific addition: bucket_length() quantizes sequence lengths onto a small
set of static shapes so XLA compiles once per bucket instead of per length.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _target_size(sizes: Sequence[int], pad_to_length: Optional[int], pad_to_multiple: int) -> int:
    size = max(sizes)
    if pad_to_length is not None:
        size = max(size, pad_to_length)
    if pad_to_multiple > 1 and size % pad_to_multiple != 0:
        size = int(((size - 0.1) // pad_to_multiple + 1) * pad_to_multiple)
    return size


def pad_1d_tokens(values: List[np.ndarray], pad_idx, pad_to_length=None, pad_to_multiple=1):
    size = _target_size([len(v) for v in values], pad_to_length, pad_to_multiple)
    res = np.full((len(values), size), pad_idx, dtype=np.asarray(values[0]).dtype)
    for i, v in enumerate(values):
        res[i, : len(v)] = v
    return res


def pad_2d(values: List[np.ndarray], pad_idx, pad_to_length=None, pad_to_multiple=1):
    size = _target_size([v.shape[0] for v in values], pad_to_length, pad_to_multiple)
    res = np.full((len(values), size, size), pad_idx, dtype=np.asarray(values[0]).dtype)
    for i, v in enumerate(values):
        n = v.shape[0]
        res[i, :n, :n] = v
    return res


def pad_coords(values: List[np.ndarray], pad_idx=0.0, pad_to_length=None, pad_to_multiple=1):
    size = _target_size([v.shape[0] for v in values], pad_to_length, pad_to_multiple)
    res = np.full((len(values), size, 3), pad_idx, dtype=np.float32)
    for i, v in enumerate(values):
        res[i, : v.shape[0], :] = v
    return res


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket if none fits)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


# Top bucket holds max_atoms+2=258 tokens.  It must be a multiple of 8 (the
# fused Pallas kernels' seq contract — 258 itself would silently fall back
# to XLA for exactly the largest molecules), and 280 = 8*35 admits a q-row
# block of 40: measured 8.03 ms/layer fwd+bwd vs 10.67 for 264 (whose only
# legal block is 24) and 9.7 for 320 — see docs/PERF.md "Top bucket".
DEFAULT_ATOM_BUCKETS = (32, 48, 64, 96, 128, 160, 192, 224, 280)
DEFAULT_SMILES_BUCKETS = (32, 48, 64, 96, 128, 192, 256, 384, 512)
