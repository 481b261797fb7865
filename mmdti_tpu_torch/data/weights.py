"""ConR sample reweighting (port of mmdti_tpu/data/weights.py, numpy and
scipy only): sqrt-inverse histogram + optional LDS smoothing.

Same math as the reference (reference data/datahub.py:44-169): 3-sigma
cleaned histogram over max_bin buckets, sqrt-inverse counts, optional
label-distribution-smoothing 1-D kernel convolution, per-sample 1/count
weights normalized to mean 1.  The reference's multiprocessing pools are
replaced with straight vectorized numpy (the work is O(n) histogramming);
``all_weight`` computes one weight column per target column (and fixes the
reference's hardcoded num_cores=17 column indexing bug,
data/datahub.py:128-132).
"""

from __future__ import annotations

import logging

import numpy as np
from scipy.ndimage import convolve1d, gaussian_filter1d
from scipy.signal.windows import triang

logger = logging.getLogger("mmdti_tpu_torch")


def get_lds_kernel_window(kernel: str = "gaussian", ks: int = 9, sigma: float = 1.0) -> np.ndarray:
    """LDS kernel, max-normalized (reference: utils/util.py get_lds_kernel_window)."""
    assert kernel in ("gaussian", "triang", "laplace")
    half_ks = (ks - 1) // 2
    if kernel == "gaussian":
        base = np.zeros(ks, dtype=np.float64)
        base[half_ks] = 1.0
        smoothed = gaussian_filter1d(base, sigma=sigma)
        return smoothed / smoothed.max()
    if kernel == "triang":
        return triang(ks)
    xs = np.arange(-half_ks, half_ks + 1, dtype=np.float64)
    lap = np.exp(-np.abs(xs) / sigma) / (2.0 * sigma)
    return lap / lap.max()


def _three_sigma_clean(values: np.ndarray) -> np.ndarray:
    mean = values.mean()
    std = values.std(ddof=1) if len(values) > 1 else 0.0
    if std == 0:
        return values
    keep = (values > mean - 3 * std) & (values < mean + 3 * std)
    return values[keep]


def calculate_weights(
    values: np.ndarray,
    reweight: str = "sqrt_inv",
    max_bin: int = 200,
    lds: bool = False,
    lds_kernel: str = "gaussian",
    lds_ks: int = 9,
    lds_sigma: float = 1.0,
) -> np.ndarray:
    """Per-sample weights from the (cleaned) label histogram."""
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    cleaned = _three_sigma_clean(values)
    vmin = cleaned.min()
    value_range = cleaned.max() - vmin
    if value_range <= 0 or max_bin <= 0:
        return np.ones_like(values, dtype=np.float32)
    bin_width = value_range / max_bin

    raw_bins = np.floor((values - vmin) / bin_width).astype(np.int64)
    clean_bins = np.floor((cleaned - vmin) / bin_width).astype(np.int64)
    counts = np.bincount(np.clip(clean_bins, 0, max_bin), minlength=max_bin + 1).astype(np.float64)

    if reweight == "sqrt_inv":
        per_bin = np.sqrt(counts)
    else:
        per_bin = counts.copy()

    if lds:
        logger.info("Using LDS label smoothing for weights")
        window = get_lds_kernel_window(lds_kernel, lds_ks, lds_sigma)
        per_bin = convolve1d(per_bin, weights=window, mode="constant")

    nonzero = np.nonzero(per_bin)[0]
    lo, hi = nonzero.min(), nonzero.max()
    eff_bins = np.clip(raw_bins, lo, hi)
    num_per_label = per_bin[eff_bins]
    # guard: any remaining zero bin falls back to the nearest nonzero value
    zero = num_per_label <= 0
    if zero.any():
        num_per_label[zero] = per_bin[nonzero].min()

    weights = 1.0 / num_per_label
    weights *= len(weights) / weights.sum()
    return weights.astype(np.float32)


def compute_sample_weights(
    targets: np.ndarray,
    all_weight: bool = False,
    lds: bool = False,
    max_bin: int = 200,
    lds_kernel: str = "gaussian",
    lds_ks: int = 9,
    lds_sigma: float = 1.0,
) -> np.ndarray:
    """Weight matrix for a [N, C] target array.

    all_weight=False: one weight vector from column 0 (reference
    optimize_weighting_parallel_2 path used by finetune.py).
    all_weight=True: independent weights per column, returned [C, N] to match
    the reference's transposed layout (data/datahub.py:296-302).
    The LDS kernel/ks/sigma knobs come from config (reference lds_config,
    data/datahub.py:24-29).
    """
    targets = np.asarray(targets, dtype=np.float64)
    if targets.ndim == 1:
        targets = targets.reshape(-1, 1)
    kw = dict(max_bin=max_bin, lds=lds, lds_kernel=lds_kernel,
              lds_ks=lds_ks, lds_sigma=lds_sigma)
    if not all_weight:
        return calculate_weights(targets[:, 0], **kw)
    cols = [calculate_weights(targets[:, i], **kw) for i in range(targets.shape[1])]
    return np.stack(cols, axis=0).T  # [N, C]
