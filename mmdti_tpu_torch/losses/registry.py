"""Per-task loss / activation / output-dim registries (port of
mmdti_tpu/losses/registry.py)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from mmdti_tpu_torch.losses import zoo


def _focal(logits, target):
    return zoo.focal_loss_with_logits(logits, target)


_focal.nan_maskable = True


def _ghm(logits, target):
    loss, _ = zoo.ghmc_loss(logits, target)
    return loss


LOSS_REGISTRY = {
    "classification": zoo.cross_entropy_loss,
    "multiclass": zoo.cross_entropy_loss,
    "regression": zoo.mse_loss,
    "multilabel_classification": {
        "bce": zoo.bce_with_logits,
        "ghm": _ghm,
        "focal": _focal,
    },
    "multilabel_regression": zoo.mae_with_nan,
    "docking": zoo.docking_pose_loss,
}

ACTIVATION_REGISTRY: Dict[str, Callable] = {
    "classification": lambda x: torch.softmax(x, dim=-1)[:, 1:],
    "multiclass": lambda x: torch.softmax(x, dim=-1),
    "regression": lambda x: x,
    "multilabel_classification": torch.sigmoid,
    "multilabel_regression": lambda x: x,
    "docking": lambda x: x,
}

OUTPUT_DIM = {"classification": 2, "regression": 1, "docking": 1}


def resolve_loss(task: str, loss_key=None) -> Callable:
    entry = LOSS_REGISTRY[task]
    if isinstance(entry, dict):
        return entry[loss_key or "focal"]
    return entry


def resolve_output_dim(task: str, num_classes=None, multiclass_cnt=None) -> int:
    if task in OUTPUT_DIM:
        return OUTPUT_DIM[task]
    if task == "multiclass":
        return int(multiclass_cnt)
    return int(num_classes)


def target_is_integer(task: str) -> bool:
    """Whether labels are integers.  multilabel_classification stays float:
    its losses exclude NaN labels, which an integer cast would destroy."""
    return task in ("classification", "multiclass")
