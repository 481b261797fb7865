"""ConR / SupCon style contrastive losses (port of
mmdti_tpu/losses/contrastive.py).

  * ct_regress  — label-distance positives (|dy| <= w), mispredicted-but-close
    negatives, push weights l_dist * sample_weight * e, per-anchor normalized
    log-ratio, anchors with no negatives zeroed.
  * ct_single   — exact-label-match positives, external sample weights as push
    weights.
  * ct_multi    — label-agreement-fraction matrix thresholded at
    coef/num_classes.

The reference's quirk is kept: masked similarity entries enter the softmax
denominator as exp(0)=1.  All math in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch


def _normalize_rows(x):
    return x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-12)


def _pair_loss(prod, pos_i, neg_i, pushing_w, denom):
    """Shared tail: per-anchor normalized log-ratio with no-negative zeroing."""
    pos = prod * pos_i
    neg = prod * neg_i
    neg_exp_dot = (pushing_w * torch.exp(neg) * neg_i).sum(dim=1)
    no_neg_flag = (neg_i.sum(dim=1) > 0).to(prod.dtype)
    z = torch.exp(pos).sum(dim=1) + neg_exp_dot
    per_pair = -(pos - torch.log(z)[:, None])
    loss = (per_pair * pos_i).sum(dim=1) / denom
    return (loss * no_neg_flag).mean()


def _key_weights(weights, B, device):
    """[1, B] per-key push weights (ones without sample weights)."""
    if weights is None:
        return torch.ones((1, B), dtype=torch.float32, device=device)
    return weights.reshape(B, -1).float().mean(dim=1)[None, :]


def ct_regress(
    feature: torch.Tensor,                  # [B, F]
    target: torch.Tensor,                   # [B, C] (scaled labels)
    output: torch.Tensor,                   # [B, K] model logits/predictions
    weights: Optional[torch.Tensor] = None,  # [B] or [B, C] sample weights
    w: float = 0.2,
    t: float = 0.07,
    e: float = 0.01,
) -> torch.Tensor:
    f = feature.reshape(feature.shape[0], -1).float()
    B = f.shape[0]
    # nanmean over label columns: rows with no valid label yield NaN and are
    # excluded from every pair below
    labels = torch.nanmean(target.reshape(B, -1).float(), dim=1, keepdim=True)
    preds = output.reshape(B, -1).float().mean(dim=1, keepdim=True)
    l_dist = torch.abs(labels - labels.t())
    p_dist = torch.abs(preds - preds.t())
    valid = ~torch.isnan(l_dist)
    l_dist = torch.where(valid, l_dist, torch.full_like(l_dist, float("inf")))

    qn = _normalize_rows(f)
    eye = torch.eye(B, dtype=torch.bool, device=f.device)
    pos_i = ((l_dist <= w) & ~eye).float()
    neg_i = (valid & ~(l_dist <= w) & (p_dist <= w)).float()
    prod = (qn @ qn.t()) / t

    if weights is None:
        wvec = torch.ones((B, 1), dtype=torch.float32, device=f.device)
    else:
        wvec = weights.reshape(B, -1).float().mean(dim=1, keepdim=True)
    pushing_w = torch.where(valid, l_dist, torch.zeros_like(l_dist)) * wvec * e
    denom = torch.clamp_min((l_dist <= w).sum(dim=1).float(), 1.0)
    return _pair_loss(prod, pos_i, neg_i, pushing_w, denom)


def ct_single(
    feature: torch.Tensor,
    target: torch.Tensor,
    output: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    w: float = 0.2,
    t: float = 0.07,
    e: float = 0.2,
) -> torch.Tensor:
    del output, w, e
    f = feature.reshape(feature.shape[0], -1).float()
    B = f.shape[0]
    labels = target.reshape(B, -1).float()
    l_dist = torch.abs(labels[:, :1] - labels[:, :1].t())

    qn = _normalize_rows(f)
    eye = torch.eye(B, dtype=torch.bool, device=f.device)
    pos_i = ((l_dist == 0) & ~eye).float()
    neg_i = (l_dist != 0).float()
    prod = (qn @ qn.t()) / t
    denom = pos_i.sum(dim=1)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return _pair_loss(prod, pos_i, neg_i, _key_weights(weights, B, f.device), denom)


def ct_multi(
    feature: torch.Tensor,
    target: torch.Tensor,
    output: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    w: float = 0.2,
    t: float = 0.07,
    e: float = 0.2,
    coef: float = 1.0,
) -> torch.Tensor:
    del output, w, e
    f = feature.reshape(feature.shape[0], -1).float()
    B = f.shape[0]
    labels = target.reshape(B, -1)
    num_classes = labels.shape[1]
    agree = (labels[:, None, :] == labels[None, :, :]).float().mean(dim=-1)

    qn = _normalize_rows(f)
    eye = torch.eye(B, dtype=torch.bool, device=f.device)
    threshold = coef / num_classes
    pos_i = ((agree >= threshold) & ~eye).float()
    neg_i = (agree < threshold).float()
    prod = (qn @ qn.t()) / t
    denom = pos_i.sum(dim=1)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return _pair_loss(prod, pos_i, neg_i, _key_weights(weights, B, f.device), denom)


CT_REGISTRY = {
    "regression": ct_regress,
    "classification": ct_single,
    "multiclass": ct_single,
    "multilabel_classification": ct_multi,
    "multilabel_regression": ct_regress,
}
