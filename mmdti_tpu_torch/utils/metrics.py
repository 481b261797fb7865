"""Host-side metric registry (port of mmdti_tpu/utils/metrics.py, the
regression part).

The regression metrics (mse, rmse, mae, r2 as scikit-learn computes them;
pearson and spearman from scipy), NaN/sentinel-masked per-column averaging,
the priority order of a comma-separated metrics string, and the early-stop
direction of each metric.  The classification metrics of the JAX package
are scikit-learn's and wait for the classification slice (ROADMAP.md, M5):
``Metrics`` raises for those tasks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
from scipy.stats import pearsonr, spearmanr


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    fn: Callable
    higher_is_better: bool


def _mse(y_true, y_pred):
    return float(np.mean((np.asarray(y_true) - np.asarray(y_pred)) ** 2))


def _mae(y_true, y_pred):
    return float(np.mean(np.abs(np.asarray(y_true) - np.asarray(y_pred))))


def _rmse(y_true, y_pred):
    return float(np.sqrt(_mse(y_true, y_pred)))


def _r2(y_true, y_pred):
    """scikit-learn's r2_score (force_finite): 1 - SS_res / SS_tot, 1.0 for
    a perfect fit of constant targets, 0.0 for an imperfect one; NaN below
    two samples."""
    y_true, y_pred = np.asarray(y_true, np.float64), np.asarray(y_pred, np.float64)
    if y_true.shape[0] < 2:
        return float("nan")
    ss_res = float(np.sum((y_true - y_pred) ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot


def _pearson(y_true, y_pred):
    return float(pearsonr(y_true, y_pred)[0])


def _spearman(y_true, y_pred):
    return float(spearmanr(y_true, y_pred)[0])


REGRESSION_METRICS: Dict[str, MetricSpec] = {
    "mae": MetricSpec(_mae, False),
    "pearsonr": MetricSpec(_pearson, True),
    "spearmanr": MetricSpec(_spearman, True),
    "mse": MetricSpec(_mse, False),
    "r2": MetricSpec(_r2, True),
    "rmse": MetricSpec(_rmse, False),
}

METRICS_REGISTRY: Dict[str, Dict[str, MetricSpec]] = {
    "regression": REGRESSION_METRICS,
    "multilabel_regression": {k: REGRESSION_METRICS[k] for k in ("mae", "mse", "r2")},
}

DEFAULT_METRICS: Dict[str, List[str]] = {
    "regression": ["mse", "mae", "r2", "spearmanr", "pearsonr"],
    "multilabel_regression": ["mse", "mae", "r2"],
}

NOT_PORTED = ("classification", "multiclass", "multilabel_classification")


def masked_columnwise_metric(y_true, y_pred, fn, nan_value=None):
    """Per-column metric over the valid entries (not NaN, not the sentinel),
    averaged across columns; a column that cannot be scored is skipped."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_true.shape != y_pred.shape:
        raise ValueError("y_true and y_pred must have same shape")
    mask = ~np.isnan(y_true)
    if nan_value is not None:
        mask &= y_true != nan_value
    vals = []
    for col in range(y_true.shape[1]):
        m = mask[:, col]
        if not m.any():
            continue
        try:
            v = float(fn(y_true[m, col], y_pred[m, col]))
        except ValueError:
            continue
        if np.isnan(v):
            continue
        vals.append(v)
    return float(np.mean(vals)) if vals else float("nan")


class Metrics:
    """Metric computation and early-stop judgement for one task."""

    def __init__(self, task: str, metrics_str: Optional[str] = None, **_):
        if task in NOT_PORTED:
            raise NotImplementedError(
                f"the {task} metrics are not ported yet (ROADMAP.md, M5); the port "
                "trains regression and multilabel_regression"
            )
        if task not in METRICS_REGISTRY:
            raise ValueError(f"Unknown task: {task}")
        self.task = task
        self.registry = METRICS_REGISTRY[task]
        self.metric_names = self._resolve(metrics_str)

    def _resolve(self, metrics_str) -> List[str]:
        if not isinstance(metrics_str, str) or metrics_str in ("", "none"):
            return list(DEFAULT_METRICS[self.task])
        requested = metrics_str.split(",")
        for name in requested:
            if name not in self.registry:
                raise ValueError(f"Unknown metric: {name}")
        return requested + [k for k in self.registry if k not in requested]

    def cal_metric(self, label, predict, nan_value=-1.0, threshold=0.5, label_cnt=None):
        return {name: masked_columnwise_metric(label, predict, self.registry[name].fn,
                                               nan_value)
                for name in self.metric_names}

    def primary_metric(self) -> str:
        return self.metric_names[0]

    def is_improvement(self, score: float, best: Optional[float]) -> bool:
        if best is None or not np.isfinite(best):
            return True
        if self.registry[self.primary_metric()].higher_is_better:
            return score >= best
        return score <= best

    def initial_best(self) -> float:
        return float("-inf") if self.registry[self.primary_metric()].higher_is_better \
            else float("inf")
