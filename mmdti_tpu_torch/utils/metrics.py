"""Host-side metric registry (port of mmdti_tpu/utils/metrics.py).

Per-task registries with NaN/sentinel-masked per-column averaging, the
priority order of a comma-separated metrics string, the early-stop
direction of each metric, and the per-column threshold search of the
classification tasks.

The JAX package computes its metrics with scikit-learn, which the port
does not import.  Every metric here is written in numpy and returns what
scikit-learn 1.9 returns on the same inputs, including where it gives up:
a function raises ValueError, or returns NaN, in the cases where
scikit-learn's does, because the column average skips exactly those
columns.  The regression metrics are scikit-learn's mse, mae and r2 and
scipy's pearson and spearman; the classification ones are ROC-AUC (ties
fold into one threshold, trapezoidal area), average precision (the step
sum, not interpolated), log loss (clipped at the dtype's eps), accuracy,
F1, precision and recall (0.0 on a zero division), Matthews' correlation
(0.0 on a zero denominator) and Cohen's kappa.
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
    needs_binarized: bool = False   # computed on labels cut at the threshold


# ---- regression ------------------------------------------------------------------

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


# ---- classification: the inputs ----------------------------------------------------

def _column(y, name: str) -> np.ndarray:
    """A 1-D array, or an [n, 1] column raveled; anything wider raises."""
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim != 1:
        raise ValueError(f"{name} must be 1-D, got shape {y.shape}")
    return y


def _finite(y, name: str) -> np.ndarray:
    y = np.asarray(y)
    if y.dtype.kind not in "fiub":
        y = y.astype(np.float64)
    if y.dtype.kind == "f" and not np.isfinite(y).all():
        raise ValueError(f"Input {name} contains NaN or infinity.")
    return y


def _classes(y) -> np.ndarray:
    """The sorted labels of a target that is a set of classes: integral
    values (NaN or a fraction is a continuous target, which raises)."""
    y = np.asarray(y)
    if y.dtype.kind == "f" and not (np.isfinite(y).all() and (y == np.floor(y)).all()):
        raise ValueError("continuous targets are not class labels")
    return np.unique(y)


def _binary_target(y_true) -> np.ndarray:
    classes = _classes(y_true)
    if classes.size > 2:
        raise ValueError(f"a binary target has at most 2 classes, got {classes}")
    return classes


# ---- ROC-AUC and average precision ---------------------------------------------------

def _threshold_counts(y_pos, y_score):
    """(fps, tps): false and true positives at each distinct score, highest
    first; tied scores fold into one threshold."""
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    y_pos = y_pos[order].astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_pos.size - 1]
    tps = np.cumsum(y_pos, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps


def _binary_auc(y_pos, y_score) -> float:
    """Area under the ROC curve of a 0/1 target; NaN when one class only."""
    if np.unique(y_pos).size != 2:
        return float("nan")
    fps, tps = _threshold_counts(y_pos, y_score)
    if fps.size > 2:
        # drop the points collinear with their neighbours
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def roc_auc_score(y_true, y_score) -> float:
    """Binary ROC-AUC (scikit-learn's roc_auc_score on a 1-D target): the
    larger label is the positive class; NaN when one class only."""
    y_true = _column(y_true, "y_true")
    y_score = _finite(_column(y_score, "y_score"), "y_score")
    if y_true.shape[0] != y_score.shape[0]:
        raise ValueError("y_true and y_score have different lengths")
    classes = _binary_target(y_true)
    return _binary_auc((y_true == classes[-1]).astype(np.int64), y_score)


def roc_auc_ovr_macro(y_true, y_prob) -> float:
    """scikit-learn's roc_auc_score(multi_class="ovr", average="macro"):
    the mean of each class's one-vs-rest AUC.  Raises unless the rows sum
    to 1 and y_true holds every class the columns name."""
    y_true = _column(y_true, "y_true")
    y_prob = _finite(y_prob, "y_score")
    if y_prob.ndim != 2:
        raise ValueError("y_score must be [n_samples, n_classes]")
    if not np.allclose(1, y_prob.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc, "
                         "i.e. they should sum up to 1.0 over classes")
    classes = _classes(y_true)
    if classes.size != y_prob.shape[1]:
        raise ValueError("Number of classes in y_true not equal to the number of columns "
                         "in 'y_score'")
    score = np.zeros((classes.size,))
    for c, label in enumerate(classes):
        score[c] = _binary_auc((y_true == label).astype(np.int64), y_prob[:, c])
    return float(np.average(score))


def average_precision_score(y_true, y_score) -> float:
    """Average precision of the positive label 1: sum over thresholds of
    (R_n - R_{n-1}) P_n, the step integral; recall is 1 everywhere when
    no label is positive."""
    y_true = _column(y_true, "y_true")
    y_score = _finite(_column(y_score, "y_score"), "y_score")
    classes = _binary_target(y_true)
    if classes.size == 2 and 1 not in classes:
        raise ValueError(f"pos_label=1 is not a valid label: {classes}")
    fps, tps = _threshold_counts((y_true == 1).astype(np.int64), y_score)
    ps = tps + fps
    precision = np.where(ps != 0, np.divide(tps, ps), 0.0)
    recall = np.full(tps.shape, 1.0) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate((np.flip(precision), [1.0]))
    recall = np.concatenate((np.flip(recall), [0.0]))
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


# ---- log loss -------------------------------------------------------------------

def _xlogy(x, y):
    with np.errstate(divide="ignore", invalid="ignore"):
        temp = x * np.log(y)
    return np.where(x == 0.0, np.asarray(0.0, dtype=temp.dtype), temp)


def log_loss(y_true, y_prob, labels=None) -> float:
    """Mean negative log-likelihood.  A 1-D ``y_prob`` is the positive
    class's probability; a matrix has one column per class of ``labels``
    (or of y_true's classes).  Probabilities are clipped to [eps, 1 - eps]
    of their dtype (float32 stays float32); one class, a class count that
    differs from the columns, a label outside ``labels``, a probability
    outside [0, 1] or a non-finite one raise ValueError."""
    y_prob = np.asarray(y_prob)
    if y_prob.dtype not in (np.float64, np.float32, np.float16):
        y_prob = y_prob.astype(np.float64)
    y_prob = _finite(y_prob, "y_prob")
    if y_prob.max() > 1:
        raise ValueError(f"y_prob contains values greater than 1: {y_prob.max()}")
    if y_prob.min() < 0:
        raise ValueError(f"y_prob contains values lower than 0: {y_prob.min()}")
    y_true = _column(y_true, "y_true")
    if y_true.shape[0] != y_prob.shape[0]:
        raise ValueError("y_true and y_prob have different lengths")
    if labels is not None:
        classes = np.unique(np.asarray(labels))
        if not np.isin(y_true, classes).all():
            extra = set(y_true.tolist()) - set(classes.tolist())
            raise ValueError(f"y_true contains values {extra} not belonging to the passed "
                             f"labels {labels}.")
    else:
        classes = _classes(y_true)
    if classes.size == 1:
        raise ValueError(f"y_true contains only one label ({classes[0]}): provide the "
                         "expected labels")
    onehot = (y_true[:, None] == classes[None, :]).astype(np.int64)
    if classes.size == 2:
        onehot = np.concatenate((1 - onehot[:, 1:], onehot[:, 1:]), axis=1)
    if y_prob.ndim == 1:
        y_prob = y_prob[:, np.newaxis]
    if y_prob.shape[1] == 1:
        y_prob = np.concatenate([1 - y_prob, y_prob], axis=1)
    if classes.size != y_prob.shape[1]:
        raise ValueError(f"y_true and y_prob contain different numbers of classes: "
                         f"{classes.size} vs {y_prob.shape[1]}")
    eps = np.finfo(y_prob.dtype).eps
    y_prob = np.clip(y_prob, eps, 1 - eps)
    loss = -np.sum(_xlogy(onehot.astype(y_prob.dtype), y_prob), axis=1)
    return float(np.average(loss))


def _log_loss_labeled(y_true, y_pred, labels=None):
    """log_loss with the label set pinned.  A multiclass prob matrix over a
    y_true that misses a class (a scaffold split easily drops one) would
    otherwise raise: the matrix's width is the class count."""
    if labels is None and np.ndim(y_pred) == 2 and np.shape(y_pred)[1] > 1:
        labels = list(range(np.shape(y_pred)[1]))
    return log_loss(y_true, y_pred, labels=labels)


# ---- thresholded binary metrics ------------------------------------------------------

def _binary_pair(y_true, y_pred):
    y_true, y_pred = _column(y_true, "y_true"), _column(y_pred, "y_pred")
    if y_true.shape[0] != y_pred.shape[0]:
        raise ValueError("y_true and y_pred have different lengths")
    present = _classes(np.concatenate([_classes(y_true), _classes(y_pred)]))
    if present.size > 2:
        raise ValueError(f"a binary target has at most 2 classes, got {present}")
    if present.size == 2 and 1 not in present:
        raise ValueError(f"pos_label=1 is not a valid label: {present}")
    t, p = y_true == 1, y_pred == 1
    tp = int(np.sum(t & p))
    return tp, int(np.sum(p)), int(np.sum(t))


def _divide(num, den) -> float:
    """num / den in float64, 0.0 when den is 0 (zero_division='warn')."""
    return float(np.float64(num) / np.float64(den)) if den != 0 else 0.0


def accuracy_score(y_true, y_pred) -> float:
    y_true, y_pred = _column(y_true, "y_true"), _column(y_pred, "y_pred")
    return float(np.average(y_true == y_pred))


def precision_score(y_true, y_pred) -> float:
    tp, pred_sum, _ = _binary_pair(y_true, y_pred)
    return _divide(tp, pred_sum)


def recall_score(y_true, y_pred) -> float:
    tp, _, true_sum = _binary_pair(y_true, y_pred)
    return _divide(tp, true_sum)


def f1_score(y_true, y_pred) -> float:
    tp, pred_sum, true_sum = _binary_pair(y_true, y_pred)
    return _divide(2 * np.float64(tp), np.float64(true_sum) + np.float64(pred_sum))


def _confusion(y_true, y_pred):
    """Confusion counts over the sorted union of the labels (rows: truth)."""
    y_true, y_pred = _column(y_true, "y_true"), _column(y_pred, "y_pred")
    if y_true.shape[0] != y_pred.shape[0]:
        raise ValueError("y_true and y_pred have different lengths")
    labels = _classes(np.concatenate([y_true, y_pred]))
    conf = np.zeros((labels.size, labels.size), dtype=np.int64)
    np.add.at(conf, (np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)), 1)
    return conf


def matthews_corrcoef(y_true, y_pred) -> float:
    C = _confusion(y_true, y_pred)
    t_sum = C.sum(axis=1, dtype=np.float64)
    p_sum = C.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(C, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples ** 2 - np.dot(t_sum, t_sum)
    cov_ypyp_ytyt = cov_ypyp * cov_ytyt
    if cov_ypyp_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ypyp_ytyt))


def cohen_kappa_score(y1, y2) -> float:
    """Unweighted kappa; NaN where it is undefined (one label in common)."""
    confusion = _confusion(y1, y2).astype(np.float64)
    n_classes = confusion.shape[0]
    sum0 = np.sum(confusion, axis=0)
    sum1 = np.sum(confusion, axis=1)
    numerator = np.outer(sum0, sum1)
    denominator = np.sum(sum0)
    if denominator == 0:
        return float("nan")
    expected = numerator / denominator
    w_mat = np.ones([n_classes, n_classes], dtype=np.float64)
    np.fill_diagonal(w_mat, 0)
    numerator = np.sum(w_mat * confusion)
    denominator = np.sum(w_mat * expected)
    if denominator == 0:
        return float("nan")
    return float(1 - numerator / denominator)


def _multi_acc(y_true, y_pred):
    return float(np.mean(np.asarray(y_true).flatten() == np.argmax(y_pred, axis=1)))


# ---- registries ---------------------------------------------------------------------

REGRESSION_METRICS: Dict[str, MetricSpec] = {
    "mae": MetricSpec(_mae, False),
    "pearsonr": MetricSpec(_pearson, True),
    "spearmanr": MetricSpec(_spearman, True),
    "mse": MetricSpec(_mse, False),
    "r2": MetricSpec(_r2, True),
    "rmse": MetricSpec(_rmse, False),
}

CLASSIFICATION_METRICS: Dict[str, MetricSpec] = {
    "auroc": MetricSpec(roc_auc_score, True),
    "auc": MetricSpec(roc_auc_score, True),
    "auprc": MetricSpec(average_precision_score, True),
    "log_loss": MetricSpec(log_loss, False),
    "acc": MetricSpec(accuracy_score, True, True),
    "f1_score": MetricSpec(f1_score, True, True),
    "mcc": MetricSpec(matthews_corrcoef, True, True),
    "precision": MetricSpec(precision_score, True, True),
    "recall": MetricSpec(recall_score, True, True),
    "cohen_kappa": MetricSpec(cohen_kappa_score, True, True),
}

def _docking_split(y_true, y_pred):
    """([cross | holo] targets and predictions [n, Nm, Np + Nm]) -> Np."""
    y_true, y_pred = np.asarray(y_true, np.float64), np.asarray(y_pred, np.float64)
    if y_true.shape != y_pred.shape or y_true.ndim != 3:
        raise ValueError("docking metrics take [n, Nm, Np + Nm] targets and predictions")
    return y_true, y_pred, y_true.shape[2] - y_true.shape[1]


def docking_cross_rmse(y_true, y_pred, dist_threshold: float = 8.0) -> float:
    """RMSE of the ligand-pocket distances the docking loss keeps (target
    not 0, under ``dist_threshold`` Angstrom)."""
    t, p, Np = _docking_split(y_true, y_pred)
    t, p = t[..., :Np], p[..., :Np]
    keep = (t != 0) & (t < dist_threshold)
    return float(np.sqrt(np.mean((p[keep] - t[keep]) ** 2))) if keep.any() else float("nan")


def docking_holo_rmse(y_true, y_pred) -> float:
    """RMSE of the holo ligand distances (target not 0)."""
    t, p, Np = _docking_split(y_true, y_pred)
    t, p = t[..., Np:], p[..., Np:]
    keep = t != 0
    return float(np.sqrt(np.mean((p[keep] - t[keep]) ** 2))) if keep.any() else float("nan")


METRICS_REGISTRY: Dict[str, Dict[str, MetricSpec]] = {
    "regression": REGRESSION_METRICS,
    "classification": CLASSIFICATION_METRICS,
    "multiclass": {
        "log_loss": MetricSpec(_log_loss_labeled, False),
        "acc": MetricSpec(_multi_acc, True),
    },
    "multilabel_classification": {
        k: CLASSIFICATION_METRICS[k] for k in ("auroc", "auc", "auprc", "log_loss", "acc", "mcc")
    },
    "multilabel_regression": {k: REGRESSION_METRICS[k] for k in ("mae", "mse", "r2")},
    "docking": {"cross_rmse": MetricSpec(docking_cross_rmse, False),
                "holo_rmse": MetricSpec(docking_holo_rmse, False)},
}

DEFAULT_METRICS: Dict[str, List[str]] = {
    "regression": ["mse", "mae", "r2", "spearmanr", "pearsonr"],
    "classification": ["log_loss", "auc", "f1_score", "mcc", "acc", "precision", "recall"],
    "multiclass": ["log_loss", "acc"],
    "multilabel_classification": ["log_loss", "auc", "auprc"],
    "multilabel_regression": ["mse", "mae", "r2"],
    "docking": ["cross_rmse", "holo_rmse"],
}


def masked_columnwise_metric(y_true, y_pred, fn, nan_value=None, classification=False):
    """Per-column metric over the valid entries (not NaN, not the sentinel
    and, for classification, 0 or 1), averaged across columns; a column
    whose metric raises ValueError or is NaN (one class, say) is
    skipped."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_true.shape != y_pred.shape:
        raise ValueError("y_true and y_pred must have same shape")
    mask = ~np.isnan(y_true)
    if classification:
        mask &= (y_true == 0.0) | (y_true == 1.0)
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
    """Metric computation, early-stop judgement and threshold search for
    one task."""

    def __init__(self, task: str, metrics_str: Optional[str] = None, **_):
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
        label = np.asarray(label)
        predict = np.asarray(predict)
        if self.task in ("regression", "multilabel_regression"):
            return {name: masked_columnwise_metric(label, predict, self.registry[name].fn,
                                                   nan_value)
                    for name in self.metric_names}
        if self.task == "docking":
            return {name: self.registry[name].fn(label, predict) for name in self.metric_names}
        if self.task in ("classification", "multilabel_classification"):
            out = {}
            for name in self.metric_names:
                spec = self.registry[name]
                pred = (predict > threshold).astype(int) if spec.needs_binarized else predict
                # labels stay float: the mask drops NaN, the sentinel and
                # anything but 0 and 1 (an int cast of NaN is undefined)
                out[name] = masked_columnwise_metric(label, pred, spec.fn, nan_value,
                                                     classification=True)
            return out
        out = {}   # multiclass
        for name in self.metric_names:
            spec = self.registry[name]
            if name == "log_loss" and label_cnt is not None:
                out[name] = spec.fn(label, predict, labels=list(range(label_cnt)))
            else:
                out[name] = spec.fn(label, predict)
        return out

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

    def search_threshold(self, target, pred, steps: int = 20, nan_value=-1.0):
        """Per-column thresholds on an even grid between the column's
        smallest and largest prediction that maximize the first thresholded
        metric (F1 when none is listed).  Labels that cal_metric masks (NaN,
        the sentinel, anything but 0 and 1) are left out; a column without
        valid rows keeps 0.5."""
        target = np.asarray(target, dtype=np.float64)
        pred = np.asarray(pred, dtype=np.float64)
        spec = next((self.registry[n] for n in self.metric_names
                     if self.registry[n].needs_binarized), CLASSIFICATION_METRICS["f1_score"])
        valid = ~np.isnan(target)
        valid &= (target == 0.0) | (target == 1.0)
        if nan_value is not None:
            valid &= target != nan_value
        ths = np.full(target.shape[1], 0.5)
        for col in range(target.shape[1]):
            m = valid[:, col]
            if not m.any():
                continue
            t, p = target[m, col].astype(int), pred[m, col]
            best_score = -np.inf if spec.higher_is_better else np.inf
            best_th = 0.5
            for th in np.linspace(p.min(), p.max(), steps):
                s = spec.fn(t, (p > th).astype(int))
                better = s > best_score if spec.higher_is_better else s < best_score
                if better:
                    best_score, best_th = s, th
            ths[col] = best_th
        return ths
