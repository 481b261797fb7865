"""The train step and the eval step (port of the single-step variants of
mmdti_tpu/train/steps.py::StepBuilderMixin.build_train_step and
build_eval_step).

A train step runs the model forward with dropout on, takes
``alpha * task + beta * InfoNCE + beta * CT`` as its loss, differentiates it
(on the kernel path through the hand-written backward kernels) and hands
the gradients to the clip + Adam + apply of train/optim.py.  An eval step
runs the deterministic forward and a batch loss that ignores padded
trailing rows exactly.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from mmdti_tpu_torch.losses.contrastive import CT_REGISTRY
from mmdti_tpu_torch.train.optim import FusedAdam


def build_train_loss(loss_fn: Callable, task: str, use_infonce: bool = True,
                     use_ct: bool = True, use_weight: bool = True, alpha: float = 1.0,
                     beta: float = 0.1, ct_w: float = 0.2):
    """``train_loss(model, feats, labels, weights, generator, **model_kw) ->
    (total, metrics)``: the forward (dropout on when ``generator`` is given;
    ``model_kw`` go to the model, e.g. the FDS state) and
    ``alpha * task + beta * InfoNCE + beta * CT``.  The metrics are 0-dim
    tensors (loss, m_loss, infonce_loss, ct_loss) left on the device."""
    ct_fn = CT_REGISTRY.get(task) if use_ct else None

    def train_loss(model, feats: Mapping[str, torch.Tensor], labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, **model_kw):
        out = model(**feats, outputs="train", deterministic=generator is None,
                    generator=generator, **model_kw)
        task_loss = loss_fn(out["logits"], labels)
        total = alpha * task_loss
        infonce = out["infonce_loss"]
        if use_infonce:
            total = total + beta * infonce
        if ct_fn is not None:
            ct = ct_fn(out["pooled"], labels, out["logits"],
                       weights=weights if use_weight else None, w=ct_w)
            total = total + beta * ct
        else:
            ct = torch.zeros((), device=total.device)
        return total, {"loss": total.detach(), "m_loss": task_loss.detach(),
                       "infonce_loss": infonce.detach(), "ct_loss": ct.detach()}

    return train_loss


def build_train_step(model, optimizer: FusedAdam, loss_fn: Callable, task: str, **loss_kw):
    """``train_step(feats, labels, weights, generator) -> metrics``: the
    loss of build_train_loss (``loss_kw`` are its options), its gradients
    with respect to ``optimizer.params``, and one optimizer update.

    ``feats`` holds the model's five input tensors; ``generator`` (a
    torch.Generator on their device) draws every dropout mask of the step,
    and None runs the step without dropout; ``model_kw`` go to the model
    (the FDS state, net_target, epoch and buckets of the fit loop)."""
    train_loss = build_train_loss(loss_fn, task, **loss_kw)
    names = list(optimizer.params)
    params = [optimizer.params[n] for n in names]

    def train_step(feats: Mapping[str, torch.Tensor], labels: torch.Tensor,
                   weights: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   **model_kw) -> Dict[str, torch.Tensor]:
        total, metrics = train_loss(model, feats, labels, weights, generator, **model_kw)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        optimizer.apply(dict(zip(names, grads)))
        return metrics

    return train_step


def make_batch_loss(loss_fn: Callable):
    """Batch loss over the first ``valid_n`` rows only: padded trailing rows
    repeat the last sample and must not bias the loss.  A NaN-maskable loss
    excludes them by NaN labels; any other is averaged per row (exact for
    row-decomposable means: mse, ce, bce)."""
    if getattr(loss_fn, "nan_maskable", False):
        def batch_loss(logits, labels, valid_n):
            keep = torch.arange(logits.shape[0], device=logits.device) < valid_n
            keep = keep.reshape((-1,) + (1,) * (labels.dim() - 1))
            return loss_fn(logits, torch.where(keep, labels.float(),
                                               torch.full_like(labels.float(), float("nan"))))
    else:
        def batch_loss(logits, labels, valid_n):
            per_row = torch.stack([loss_fn(logits[i:i + 1], labels[i:i + 1])
                                   for i in range(logits.shape[0])])
            keep = (torch.arange(logits.shape[0], device=logits.device) < valid_n).float()
            return torch.sum(per_row * keep) / max(float(valid_n), 1.0)
    return batch_loss


def build_eval_step(model, loss_fn: Callable, activation_fn: Callable, alpha: float = 1.0):
    """``eval_step(feats, labels, valid_n) -> (preds, loss, pooled,
    cls_repr)`` on the deterministic forward."""
    batch_loss = make_batch_loss(loss_fn)

    @torch.no_grad()
    def eval_step(feats, labels, valid_n: int):
        out = model(**feats, outputs="train")
        loss = alpha * batch_loss(out["logits"], labels, valid_n)
        return activation_fn(out["logits"]), loss, out["pooled"], out["cls_repr"]

    return eval_step
