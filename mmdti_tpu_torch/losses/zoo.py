"""Task loss zoo (port of mmdti_tpu/losses/zoo.py).

CE / MSE / RMSE, NaN-masked MAE and BCE, masked BCE-with-logits, focal
(with logits), and GHM classification / regression with their EMA bin state
passed explicitly, or carried on the device for GHM-C (``GHMCState``).
Every loss computes in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def mse_loss(logits, target):
    return torch.mean((logits.float() - target.float()) ** 2)


# the published binding-pose recipe's --dist-threshold: cross distances at
# or past it (Angstrom) leave the loss
DOCKING_DIST_THRESHOLD = 8.0


def docking_terms(logits, target, dist_threshold: float = DOCKING_DIST_THRESHOLD):
    """The two terms of Uni-Mol's docking_pose loss over [B, Nm, Np + Nm]
    predictions and targets, [cross | holo] (models/docking.py): the MSE of
    the cross distances whose target is not 0 (pads, BOS and EOS) and under
    ``dist_threshold``, and the smooth L1 (beta 1) of the holo ligand
    distances whose target is not 0, each a mean over its kept entries
    (a masked mean: 0 where nothing is kept)."""
    Nm = logits.shape[1]
    Np = logits.shape[2] - Nm
    pred, target = logits.float(), target.float()
    ct, ht = target[..., :Np], target[..., Np:]
    keep_c = ((ct != 0) & (ct < dist_threshold)).float()
    keep_h = (ht != 0).float()
    cross = torch.sum(keep_c * (pred[..., :Np] - ct) ** 2) / keep_c.sum().clamp_min(1.0)
    d = torch.abs(pred[..., Np:] - ht)
    smooth = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    holo = torch.sum(keep_h * smooth) / keep_h.sum().clamp_min(1.0)
    return cross, holo


def docking_pose_loss(logits, target):
    """Uni-Mol's docking_pose loss: cross-distance MSE + holo-distance
    smooth L1 (``docking_terms``)."""
    cross, holo = docking_terms(logits, target)
    return cross + holo


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

def _ghm_bins(g, bins):
    """(bin of each element, counts per bin as float32).  The counts are a
    one-hot sum: torch.bincount reads its input's max back to the host,
    which a CUDA graph capture forbids; small integer counts in float32 are
    exact either way."""
    bin_idx = torch.clamp(torch.floor(g * (bins - 0.0001)).long(), 0, bins - 1)
    onehot = bin_idx.reshape(-1, 1) == torch.arange(bins, device=g.device)
    return bin_idx, onehot.sum(dim=0, dtype=torch.float32)


def _ghm_weight(bin_idx, bin_count, n):
    """Per-element weight n / (count of its bin x nonempty bins)."""
    nonempty = (bin_count > 0).sum().float()
    beta = n / torch.clamp_min(bin_count * nonempty, 1e-4)
    return beta[bin_idx]


def ghmc_loss(
    logits, target, last_bin_count: Optional[torch.Tensor] = None,
    bins: int = 10, alpha: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient-harmonized BCE.  Returns (loss, new_bin_count)."""
    x = logits.float()
    y = target.float()
    g = torch.abs(torch.sigmoid(x).detach() - y)
    bin_idx, bin_count = _ghm_bins(g, bins)
    if last_bin_count is not None:
        bin_count = alpha * last_bin_count + (1 - alpha) * bin_count
    weight = _ghm_weight(bin_idx, bin_count, x.numel())
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
    bin_idx, bin_count = _ghm_bins(g, bins)
    if last_bin_count is not None:
        bin_count = alpha * last_bin_count + (1 - alpha) * bin_count
    loss = (torch.sqrt(d * d + mu * mu) - mu) * _ghm_weight(bin_idx, bin_count, x.numel())
    return loss.sum() / x.numel(), bin_count


class GHMCState:
    """GHM-C with its EMA bin counts carried from step to step (the JAX
    NNModel's ``ghm_stateful`` and its (bins, initialised flag) loss
    state): a call before any other weighs by the batch's own counts, every
    later call by the EMA of the carried counts and the batch's.  Each call
    writes the new counts and sets the flag in place, on the device, so a
    CUDA graph that records train steps replays the update; ``graph_state``
    lists the tensors a call writes, ``reset`` starts a fit afresh, and
    ``state_dict``/``load_state_dict`` save and restore them (a resume)."""

    def __init__(self, device, bins: int = 10, alpha: float = 0.5):
        self.bins, self.alpha = bins, alpha
        self.bin_count = torch.zeros(bins, dtype=torch.float32, device=device)
        self.flag = torch.zeros((), dtype=torch.float32, device=device)

    @property
    def graph_state(self):
        return (self.bin_count, self.flag)

    def state_dict(self):
        """The bins and flag by name (the tensors themselves)."""
        return {"bin_count": self.bin_count, "flag": self.flag}

    @torch.no_grad()
    def load_state_dict(self, state) -> None:
        """Copy saved bins and flag in, in place."""
        self.bin_count.copy_(state["bin_count"])
        self.flag.copy_(state["flag"])

    @torch.no_grad()
    def reset(self) -> None:
        self.bin_count.zero_()
        self.flag.zero_()

    def __call__(self, logits, target):
        x = logits.float()
        y = target.float()
        g = torch.abs(torch.sigmoid(x).detach() - y)
        bin_idx, counts = _ghm_bins(g, self.bins)
        ema = self.alpha * self.bin_count + (1 - self.alpha) * counts
        bin_count = torch.where(self.flag > 0, ema, counts)
        loss = (_bce_elementwise(x, y) * _ghm_weight(bin_idx, bin_count, x.numel())).mean()
        with torch.no_grad():
            self.bin_count.copy_(bin_count)
            self.flag.fill_(1.0)
        return loss
