"""Task loss zoo (port of mmdti_tpu/losses/zoo.py).

CE / MSE / RMSE, NaN-masked MAE and BCE, masked BCE-with-logits, focal
(with logits), and GHM classification / regression with their EMA bin state
passed explicitly.  Every loss computes in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def mse_loss(logits, target):
    return torch.mean((logits.float() - target.float()) ** 2)


def rmse_loss(logits, target, eps: float = 1e-6):
    return torch.sqrt(mse_loss(logits, target) + eps)


def cross_entropy_loss(logits, target):
    """CE over class logits; integer targets flattened."""
    target = target.reshape(-1).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, target[:, None]).mean()


def _bce_elementwise(x, y):
    return torch.clamp_min(x, 0) - x * y + torch.log1p(torch.exp(-torch.abs(x)))


def bce_with_logits(logits, target):
    return torch.mean(_bce_elementwise(logits.float(), target.float()))


def _valid_01(target):
    """(labels with NaN -> -1, fp32 mask of the {0,1} labels)."""
    y = torch.nan_to_num(target.float(), nan=-1.0)
    return y, ((y == 0.0) | (y == 1.0)).float()


def masked_bce_with_logits(logits, target):
    """NaN targets are excluded; only {0,1} targets contribute."""
    y, mask = _valid_01(target)
    elem = _bce_elementwise(logits.float(), torch.where(mask > 0, y, torch.zeros_like(y)))
    return (elem * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def mae_with_nan(logits, target):
    y = target.float()
    mask = ~torch.isnan(y)
    diff = torch.abs(logits.float() - torch.where(mask, y, torch.zeros_like(y)))
    return (diff * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def bce_with_nan(logits, target):
    y = target.float()
    mask = ~torch.isnan(y)
    elem = _bce_elementwise(logits.float(), torch.where(mask, y, torch.zeros_like(y)))
    return (elem * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def focal_loss_with_logits(logits, target, alpha: float = 0.25, gamma: float = 2.0):
    """Sigmoid focal loss over valid {0,1} targets, two-class expansion."""
    p = torch.sigmoid(logits.float())
    y, mask = _valid_01(target)
    y_v = torch.where(mask > 0, y, torch.zeros_like(y))
    p1 = torch.clamp(p, 1e-5, 1.0)
    p0 = torch.clamp(1.0 - p, 1e-5, 1.0)
    per = -alpha * (y_v * (1 - p1) ** gamma * torch.log(p1)
                    + (1 - y_v) * (1 - p0) ** gamma * torch.log(p0))
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


# NaN-targets-are-excluded losses: padded eval rows can be masked exactly by
# setting their labels to NaN (train/steps.py::make_batch_loss).
for _fn in (masked_bce_with_logits, mae_with_nan, bce_with_nan, focal_loss_with_logits):
    _fn.nan_maskable = True


# ---- GHM with explicit EMA bin state ---------------------------------------

def _ghm_beta(g, last_bin_count, bins, alpha):
    """(per-element weight, new bin counts) of the gradient-density bins."""
    bin_idx = torch.clamp(torch.floor(g * (bins - 0.0001)).long(), 0, bins - 1)
    bin_count = torch.bincount(bin_idx.reshape(-1), minlength=bins).float()
    if last_bin_count is not None:
        bin_count = alpha * last_bin_count + (1 - alpha) * bin_count
    nonempty = (bin_count > 0).sum().float()
    beta = g.numel() / torch.clamp_min(bin_count * nonempty, 1e-4)
    return beta[bin_idx], bin_count


def ghmc_loss(
    logits, target, last_bin_count: Optional[torch.Tensor] = None,
    bins: int = 10, alpha: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient-harmonized BCE.  Returns (loss, new_bin_count)."""
    x = logits.float()
    y = target.float()
    g = torch.abs(torch.sigmoid(x).detach() - y)
    weight, bin_count = _ghm_beta(g, last_bin_count, bins, alpha)
    return (_bce_elementwise(x, y) * weight).mean(), bin_count


def ghmr_loss(
    logits, target, last_bin_count: Optional[torch.Tensor] = None,
    bins: int = 10, alpha: float = 0.5, mu: float = 0.02,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient-harmonized smooth-L1 regression.  Returns (loss, new_bin_count)."""
    x = logits.float()
    y = target.float()
    d = x - y
    g = torch.abs((d / torch.sqrt(d * d + mu * mu)).detach())
    weight, bin_count = _ghm_beta(g, last_bin_count, bins, alpha)
    loss = (torch.sqrt(d * d + mu * mu) - mu) * weight
    return loss.sum() / x.numel(), bin_count
