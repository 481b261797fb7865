"""Feature Distribution Smoothing on tensors (port of mmdti_tpu/losses/fds.py).

The state is an explicit dict of tensors on the model's device, updated once
per epoch from the epoch's pooled training features:

  * buckets come from the raw training labels (optionally standard-scaled
    and 3-sigma cleaned) through (min, bin_width) computed once on the host;
  * per-bucket running mean/var by EMA with momentum 0.9, factor 0 on the
    first update epoch, unbiased variance except for single-sample buckets;
  * out-of-range samples join an edge bucket only when some sample lands
    exactly on it (the reference's witness rule);
  * a 1-D kernel (gaussian/triang/laplace) smooths the statistics over the
    bucket axis with reflect padding;
  * the train-time recalibration (f - mu_run) * sqrt(clip(v_smooth/v_run)) +
    mu_smooth, passing features through where v_run == 0.

Per-bucket sums are one-hot matrix products, so they add in a fixed order on
every device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d
from scipy.signal.windows import triang

from mmdti_tpu_torch.configs.architectures import FDSConfig


def fds_kernel_window(kernel: str = "gaussian", ks: int = 5, sigma: float = 2.0) -> np.ndarray:
    """Sum-normalized smoothing kernel (reference: fds.py:69-84)."""
    assert kernel in ("gaussian", "triang", "laplace")
    half_ks = (ks - 1) // 2
    if kernel == "gaussian":
        base = np.zeros(ks, dtype=np.float32)
        base[half_ks] = 1.0
        win = gaussian_filter1d(base, sigma=sigma)
        return (win / win.sum()).astype(np.float32)
    if kernel == "triang":
        win = triang(ks)
        return (win / win.sum()).astype(np.float32)
    xs = np.arange(-half_ks, half_ks + 1, dtype=np.float64)
    lap = np.exp(-np.abs(xs) / sigma) / (2.0 * sigma)
    return (lap / lap.sum()).astype(np.float32)


def fds_bucket_params(raw_values: np.ndarray, bucket_num: int,
                      using_scale: bool = True) -> Tuple[float, float]:
    """(min_value, bin_width) from raw training labels (reference:
    fds.py:48-57)."""
    vals = np.asarray(raw_values, dtype=np.float64).reshape(-1)
    vals = vals[~np.isnan(vals)]
    if vals.size == 0:
        raise ValueError("FDS bucket fit: no finite training labels")
    if using_scale:
        mu, sd = vals.mean(), vals.std()
        vals = (vals - mu) / (sd if sd > 0 else 1.0)
        m, s = vals.mean(), vals.std(ddof=1) if len(vals) > 1 else 0.0
        if s > 0:
            vals = vals[(vals > m - 3 * s) & (vals < m + 3 * s)]
    value_range = vals.max() - vals.min()
    if not np.isfinite(value_range) or value_range <= 0.0:
        raise ValueError(
            "FDS bucket fit: training labels span zero range "
            f"({vals.min()}); feature smoothing needs varying targets"
        )
    return float(vals.min()), float(value_range / bucket_num) if bucket_num else 1.0


def init_fds_state(cfg: FDSConfig, device=None) -> Dict[str, torch.Tensor]:
    nb, fd = cfg.bucket_num - cfg.bucket_start, cfg.feature_dim

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "running_mean": full((nb, fd), 0.0),
        "running_var": full((nb, fd), 1.0),
        "running_mean_last_epoch": full((nb, fd), 0.0),
        "running_var_last_epoch": full((nb, fd), 1.0),
        "smoothed_mean_last_epoch": full((nb, fd), 0.0),
        "smoothed_var_last_epoch": full((nb, fd), 1.0),
        "num_samples_tracked": full((nb,), 0.0),
        "epoch": full((), float(cfg.start_update)),
    }


def _bucket_assignment(labels, min_value, bin_width, cfg: FDSConfig):
    """Effective bucket per sample and the inclusion mask (witness rule)."""
    y = labels.reshape(labels.shape[0], -1)[:, 0].float()
    raw_bin = torch.floor((y - min_value) / bin_width).to(torch.int32)
    lo, hi = cfg.bucket_start, cfg.bucket_num - 1
    in_range = (raw_bin >= lo) & (raw_bin <= hi)
    has_lo, has_hi = (raw_bin == lo).any(), (raw_bin == hi).any()
    included = in_range | ((raw_bin < lo) & has_lo) | ((raw_bin > hi) & has_hi)
    eff = (raw_bin.clamp(lo, hi) - cfg.bucket_start).long()
    return eff, included


def _calibrate(feats, m1, v1, m2, v2, clip_min=0.1, clip_max=10.0):
    """calibrate_mean_var (reference: utils/util.py:159-169), rowwise."""
    total_v1 = v1.sum(dim=-1, keepdim=True)
    factor = (v2 / torch.where(v1 == 0.0, torch.ones_like(v1), v1)).clamp(clip_min, clip_max)
    calibrated = (feats - m1) * torch.sqrt(factor) + m2
    calibrated = torch.where(v1 == 0.0, feats, calibrated)
    return torch.where(total_v1 < 1e-10, feats, calibrated)


def fds_smooth(state: Dict[str, torch.Tensor], features: torch.Tensor, labels: torch.Tensor,
               epoch, min_value: float, bin_width: float, cfg: FDSConfig) -> torch.Tensor:
    """Recalibrate features [B, F] by the bucket of each label, from epoch
    ``cfg.start_smooth`` on.  ``epoch`` is a number or a 0-dim tensor on the
    features' device (the fit loop's, which a CUDA graph reads as it
    stands at each replay)."""
    eff, included = _bucket_assignment(labels, min_value, bin_width, cfg)
    f32 = features.float()
    calibrated = _calibrate(f32, state["running_mean_last_epoch"][eff],
                            state["running_var_last_epoch"][eff],
                            state["smoothed_mean_last_epoch"][eff],
                            state["smoothed_var_last_epoch"][eff])
    gate = included & (epoch >= cfg.start_smooth)
    return torch.where(gate[:, None], calibrated, f32).to(features.dtype)


def fds_update_running_stats(state, features, labels, epoch: float, min_value: float,
                             bin_width: float, cfg: FDSConfig) -> Dict[str, torch.Tensor]:
    nb = cfg.bucket_num - cfg.bucket_start
    eff, included = _bucket_assignment(labels, min_value, bin_width, cfg)
    f32 = features.float()
    w = included.float()
    onehot = torch.nn.functional.one_hot(eff, nb).float() * w[:, None]    # [N, nb]
    count = onehot.sum(dim=0)
    s1 = onehot.t() @ f32
    s2 = onehot.t() @ (f32 * f32)
    mean = s1 / count.clamp_min(1.0)[:, None]
    # unbiased variance; single-sample buckets get 0
    var = torch.where((count > 1.0)[:, None],
                      (s2 - count[:, None] * mean * mean) / (count - 1.0).clamp_min(1.0)[:, None],
                      torch.zeros_like(mean)).clamp_min(0.0)
    present = (count > 0)[:, None]
    tracked = state["num_samples_tracked"] + count
    if cfg.momentum is not None:
        factor = torch.full((nb,), cfg.momentum, dtype=torch.float32, device=f32.device)
    else:
        factor = 1.0 - count / tracked.clamp_min(1.0)
    if float(epoch) == cfg.start_update:
        factor = torch.zeros_like(factor)
    new_mean = (1.0 - factor)[:, None] * mean + factor[:, None] * state["running_mean"]
    new_var = (1.0 - factor)[:, None] * var + factor[:, None] * state["running_var"]
    out = dict(state)
    out["num_samples_tracked"] = tracked
    out["running_mean"] = torch.where(present, new_mean, state["running_mean"])
    out["running_var"] = torch.where(present, new_var, state["running_var"])
    return out


def fds_update_last_epoch_stats(state, epoch: float,
                                kernel_window: np.ndarray) -> Dict[str, torch.Tensor]:
    """Roll the running stats into *_last_epoch and kernel-smooth them over
    the buckets (reference: fds.py:86-114); only when epoch equals the
    state's epoch + 1."""
    if float(epoch) != float(state["epoch"]) + 1.0:
        return dict(state)
    nb = state["running_mean"].shape[0]
    ks = len(kernel_window)
    half = (ks - 1) // 2
    win = torch.as_tensor(np.asarray(kernel_window, np.float32), device=state["epoch"].device)
    refl = torch.as_tensor(np.pad(np.arange(nb), half, mode="reflect"),
                           device=state["epoch"].device)
    idx = refl[torch.arange(nb, device=refl.device)[:, None]
               + torch.arange(ks, device=refl.device)[None, :]]          # [nb, ks]

    def smooth(arr):
        return torch.einsum("k,nkf->nf", win, arr[idx])

    out = dict(state)
    out["epoch"] = state["epoch"] + 1.0
    out["running_mean_last_epoch"] = state["running_mean"]
    out["running_var_last_epoch"] = state["running_var"]
    out["smoothed_mean_last_epoch"] = smooth(state["running_mean"])
    out["smoothed_var_last_epoch"] = smooth(state["running_var"])
    return out


def fds_epoch_update(state, features, labels, epoch: float, min_value: float, bin_width: float,
                     kernel_window: np.ndarray, cfg: FDSConfig) -> Dict[str, torch.Tensor]:
    """The per-epoch FDS update: the last-epoch roll, then the running-stats
    EMA over the epoch's features [Ntrain, F] and labels."""
    state = fds_update_last_epoch_stats(state, epoch, kernel_window)
    return fds_update_running_stats(state, features, labels, epoch, min_value, bin_width, cfg)
