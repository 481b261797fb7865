"""Multiclass classification through the port's MolTrain.fit ->
MolPredict on the CPU against the JAX package's, on the same data and
initial weights (tests/torch_task_parity.py): 3 classes, CE + InfoNCE +
CT_Single, metrics="log_loss" (the early stop goes down).

* the history epoch by epoch and the early-stop metric (1e-5);
* cv_pred and MolPredict's class probabilities (1e-5 abs / 1e-4 rel),
  rows summing to 1;
* multiclass_cnt in both config.yaml files;
* the predict CSV: prob_0..prob_2 and the argmax, and the same
  test_metric.result file;
* the JAX MolPredict on the port's experiment dir.
"""

import numpy as np
import pytest
import torch

from tests.torch_task_parity import (
    assert_csv_equal,
    assert_history_equal,
    assert_jax_predicts_port_experiment,
    assert_predictions_equal,
    both_fits,
    one_thread,
)

# every class in the 16 training rows; the 4 validation rows miss class 2
LABELS = [0, 1, 2, 0, 1, 2, 2, 1, 0, 0, 1, 2, 0, 1, 2, 1, 0, 1, 1, 0]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    threads = one_thread()
    try:
        yield both_fits(tmp_path_factory.mktemp("multiclass"), "multiclass", {"cls": LABELS},
                        "log_loss")
    finally:
        torch.set_num_threads(threads)


def test_history_matches_jax(fits):
    assert_history_equal(fits, "log_loss")
    assert np.isfinite(fits["port"]["hist"][-1]["val_log_loss"])


def test_predictions_match_jax(fits):
    assert_predictions_equal(fits)
    pred = fits["port"]["pred"]
    assert pred.shape == (4, 3)
    np.testing.assert_allclose(pred.sum(axis=1), 1.0, atol=1e-5)


def test_multiclass_cnt_in_config(fits):
    assert fits["port"]["config"]["multiclass_cnt"] == fits["jax"]["config"]["multiclass_cnt"] == 3


def test_predict_csv_matches_jax(fits):
    assert_csv_equal(fits)
    csv = fits["port"]["csv"]
    assert {"prob_0", "prob_1", "prob_2", "predict_cls"} <= set(csv.columns)
    np.testing.assert_array_equal(csv["predict_cls"], np.argmax(fits["port"]["pred"], axis=1))


def test_jax_molpredict_reads_the_port_experiment(fits, tmp_path):
    assert_jax_predicts_port_experiment(fits, tmp_path)
