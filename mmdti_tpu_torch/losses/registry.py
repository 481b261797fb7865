"""Per-task activation and output-dim registries (the serving half of
mmdti_tpu/losses/registry.py; the training losses are not ported yet)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

ACTIVATION_REGISTRY: Dict[str, Callable] = {
    "classification": lambda x: torch.softmax(x, dim=-1)[:, 1:],
    "multiclass": lambda x: torch.softmax(x, dim=-1),
    "regression": lambda x: x,
    "multilabel_classification": torch.sigmoid,
    "multilabel_regression": lambda x: x,
}

OUTPUT_DIM = {"classification": 2, "regression": 1}


def resolve_output_dim(task: str, num_classes=None, multiclass_cnt=None) -> int:
    if task in OUTPUT_DIM:
        return OUTPUT_DIM[task]
    if task == "multiclass":
        return int(multiclass_cnt)
    return int(num_classes)
