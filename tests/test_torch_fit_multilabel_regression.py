"""Multilabel regression through the port's MolTrain.fit -> MolPredict on
the CPU against the JAX package's, on the same data and initial weights
(tests/torch_task_parity.py): two target columns with NaN holes, MAE with
NaN + InfoNCE + CT_Regress, the per-column target scaler, metrics="mae".

* the history epoch by epoch and the early-stop metric (1e-5);
* cv_pred and MolPredict's predictions, inverse-scaled (1e-5 abs / 1e-4
  rel);
* the predict CSV: the same predict_<col> columns and the same
  test_metric.result file;
* the same fit with target_normalize="quantile" over the NaN-masked
  columns.
"""

import numpy as np
import pytest
import torch

from tests.torch_task_parity import (
    assert_csv_equal,
    assert_history_equal,
    assert_predictions_equal,
    both_fits,
    one_thread,
)


def _columns():
    rng = np.random.RandomState(1)
    y1, y2 = rng.randn(20) * 2 + 1, rng.randn(20) - 3
    y1[::6] = np.nan
    y2[1::5] = np.nan
    return {"y1": y1, "y2": y2}


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    threads = one_thread()
    try:
        yield both_fits(tmp_path_factory.mktemp("mlreg"), "multilabel_regression", _columns(),
                        "mae")
    finally:
        torch.set_num_threads(threads)


def test_history_matches_jax(fits):
    assert_history_equal(fits, "mae")
    assert np.isfinite(fits["port"]["hist"][-1]["val_mae"])


def test_predictions_match_jax(fits):
    assert_predictions_equal(fits)
    assert fits["port"]["pred"].shape == (4, 2) and np.isfinite(fits["port"]["pred"]).all()


def test_quantile_fit_matches_jax(tmp_path):
    """target_normalize="quantile" over the NaN-masked columns (one
    QuantileTransformer a column, fitted on its non-NaN rows): both
    packages' fit -> predict at the same tolerances."""
    import warnings

    import joblib

    threads = one_thread()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # scikit-learn's n_quantiles warning
            fits = both_fits(tmp_path, "multilabel_regression", _columns(), "mae",
                             target_normalize="quantile")
            scalers = joblib.load(str(tmp_path / "exp_port" / "target_scaler.ss"))
    finally:
        torch.set_num_threads(threads)
    assert_history_equal(fits, "mae")
    assert_predictions_equal(fits)
    assert [type(s).__name__ for s in scalers] == ["QuantileTransformer"] * 2


def test_predict_csv_matches_jax(fits):
    assert_csv_equal(fits)
    assert {"predict_y1", "predict_y2"} <= set(fits["port"]["csv"].columns)
