"""The port's classification metrics (mmdti_tpu_torch/utils/metrics.py,
numpy, no scikit-learn) against scikit-learn, and its Metrics against the
JAX package's (which calls scikit-learn), at 1e-12:

* ROC-AUC, average precision and log loss of a binary column, and the
  thresholded accuracy, F1, precision, recall, Matthews' correlation and
  Cohen's kappa, on seeded draws: ties, probabilities of exactly 0 and 1,
  single-class columns, one-row columns and a NaN score (where
  scikit-learn raises ValueError or returns NaN, so does the port);
* multiclass log loss in float32 and float64, with the labels pinned and
  a class missing from y_true, and the macro one-vs-rest AUC;
* Metrics.cal_metric for classification, multilabel classification (NaN
  and -1 labels, a single-class column) and multiclass (label_cnt, a
  missing class), and Metrics.search_threshold, against the JAX Metrics;
* the registries, their default lists and the early-stop direction.
"""

import warnings

import numpy as np
import pytest
import sklearn.metrics as skm

from mmdti_tpu.utils import metrics as jax_metrics
from mmdti_tpu_torch.utils import metrics

TOL = 1e-12
KINDS = ("random", "ties", "zero_one", "single_class", "one_row", "nan_score")
SEEDS = range(4)


def _draw(kind, seed, n=24):
    rng = np.random.RandomState(100 * KINDS.index(kind) + seed)
    if kind == "one_row":
        n = 1
    y = rng.randint(0, 2, n).astype(np.float64)
    p = rng.rand(n)
    if kind == "ties":
        p = np.round(p * 3) / 3
    elif kind == "zero_one":
        p[rng.rand(n) < 0.3] = 0.0
        p[rng.rand(n) < 0.3] = 1.0
    elif kind == "single_class":
        y[:] = seed % 2
    elif kind == "nan_score":
        p[1] = np.nan
    return y, p


def _outcome(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return float(fn(*args, **kw))
        except ValueError:
            return "ValueError"


def _assert_same(got, want):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
    elif np.isnan(want):
        assert np.isnan(got)
    else:
        assert abs(got - want) <= TOL, (got, want)


RANKING = {"roc_auc": (skm.roc_auc_score, metrics.roc_auc_score),
           "average_precision": (skm.average_precision_score, metrics.average_precision_score),
           "log_loss": (skm.log_loss, metrics.log_loss)}
THRESHOLDED = {"accuracy": (skm.accuracy_score, metrics.accuracy_score),
               "f1": (skm.f1_score, metrics.f1_score),
               "precision": (skm.precision_score, metrics.precision_score),
               "recall": (skm.recall_score, metrics.recall_score),
               "mcc": (skm.matthews_corrcoef, metrics.matthews_corrcoef),
               "cohen_kappa": (skm.cohen_kappa_score, metrics.cohen_kappa_score)}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(RANKING))
def test_ranking_metrics_match_sklearn(name, kind):
    want_fn, got_fn = RANKING[name]
    for seed in SEEDS:
        y, p = _draw(kind, seed)
        _assert_same(_outcome(got_fn, y, p), _outcome(want_fn, y, p))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(THRESHOLDED))
def test_thresholded_metrics_match_sklearn(name, kind):
    want_fn, got_fn = THRESHOLDED[name]
    for seed in SEEDS:
        y, p = _draw(kind, seed)
        pred = (np.nan_to_num(p) > 0.5).astype(np.float64)
        if kind == "single_class" and seed >= 2:
            pred[:] = y[0]                          # one label in both: undefined kappa
        _assert_same(_outcome(got_fn, y, pred), _outcome(want_fn, y, pred))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("classes_present", [3, 2])
def test_multiclass_log_loss_matches_sklearn(dtype, classes_present):
    for seed in SEEDS:
        rng = np.random.RandomState(seed)
        y = rng.randint(0, classes_present, (30, 1))
        p = rng.rand(30, 3).astype(dtype)
        p /= p.sum(axis=1, keepdims=True)
        for labels in (None, [0, 1, 2]):
            _assert_same(_outcome(metrics.log_loss, y, p, labels=labels),
                         _outcome(skm.log_loss, y, p, labels=labels))
        _assert_same(_outcome(metrics._log_loss_labeled, y, p),
                     _outcome(jax_metrics._log_loss_labeled, y, p))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ovr_macro_auc_matches_sklearn(dtype):
    for seed in SEEDS:
        rng = np.random.RandomState(seed)
        y = np.r_[0, 1, 2, rng.randint(0, 3, 27)]
        p = rng.rand(30, 3).astype(dtype)
        p[:5] = np.round(p[:5], 1)                  # ties
        p /= p.sum(axis=1, keepdims=True)
        _assert_same(_outcome(metrics.roc_auc_ovr_macro, y, p),
                     _outcome(skm.roc_auc_score, y, p, multi_class="ovr", average="macro"))
    # a class missing from y_true and rows that do not sum to 1 raise in both
    for y, p in ((np.r_[0, 1, 1, 0], np.full((4, 3), 1 / 3)), (np.r_[0, 1, 2], np.ones((3, 3)))):
        _assert_same(_outcome(metrics.roc_auc_ovr_macro, y, p),
                     _outcome(skm.roc_auc_score, y, p, multi_class="ovr", average="macro"))


def _cal_cases(task, seed):
    rng = np.random.RandomState(seed)
    if task == "multiclass":
        classes = 3 if seed % 2 else 2                # seed 0, 2: class 2 missing
        y = rng.randint(0, classes, (40, 1))
        p = rng.rand(40, 3).astype(np.float32)
        return y, p / p.sum(axis=1, keepdims=True)
    cols = 1 if task == "classification" else 3
    y = rng.randint(0, 2, (40, cols)).astype(np.float64)
    p = np.clip(y * 0.5 + 0.5 * rng.rand(40, cols), 0, 1).astype(np.float32)
    p[:4] = np.round(p[:4], 1)                        # ties
    p[4, 0], p[5, 0] = 0.0, 1.0
    y[6::9, 0] = np.nan
    y[7::11, 0] = -1.0
    if cols > 1:
        y[:, 1] = 1.0                                 # a single-class column
        y[::3, 2] = np.nan
    if seed == 3:
        y[:, 0] = 0.0
    return y, p


TASKS = ("classification", "multilabel_classification", "multiclass")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("task", TASKS)
def test_cal_metric_matches_jax(task, seed):
    y, p = _cal_cases(task, seed)
    metric_str = {"multiclass": "log_loss"}.get(task, "auc")
    ours, theirs = metrics.Metrics(task, metric_str), jax_metrics.Metrics(task, metric_str)
    assert ours.metric_names == theirs.metric_names
    kws = [{}] + ([{"label_cnt": 3}] if task == "multiclass" else [{"threshold": 0.3}])
    for kw in kws:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, want = ours.cal_metric(y, p, **kw), theirs.cal_metric(y, p, **kw)
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], float(want[k]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("task,metric_str", [("classification", "auc"),
                                             ("classification", "mcc,auc"),
                                             ("multilabel_classification", "auc")])
def test_search_threshold_matches_jax(task, metric_str, seed):
    y, p = _cal_cases(task, seed)
    if task == "multilabel_classification":
        y[:, 1] = -1.0                                # a column without valid rows
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = metrics.Metrics(task, metric_str).search_threshold(y, p)
        want = jax_metrics.Metrics(task, metric_str).search_threshold(y, p)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("task", list(jax_metrics.METRICS_REGISTRY))
def test_registries_match_jax(task):
    ours, theirs = metrics.METRICS_REGISTRY[task], jax_metrics.METRICS_REGISTRY[task]
    assert list(ours) == list(theirs)
    for name in theirs:
        assert ours[name].higher_is_better == theirs[name].higher_is_better, name
        assert ours[name].needs_binarized == theirs[name].needs_binarized, name
    assert metrics.DEFAULT_METRICS[task] == jax_metrics.DEFAULT_METRICS[task]
    for metric_str in (None, "none", ",".join(reversed(list(theirs)))):
        m, j = metrics.Metrics(task, metric_str), jax_metrics.Metrics(task, metric_str)
        assert m.metric_names == j.metric_names
        assert m.initial_best() == j.initial_best()
        for score, best in ((0.7, 0.6), (0.6, 0.7), (0.6, 0.6)):
            assert m.is_improvement(score, best) == j.is_improvement(score, best)
