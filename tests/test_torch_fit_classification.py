"""Binary classification through the port's MolTrain.fit -> MolPredict on
the CPU against the JAX package's, on the same data and initial weights
(tests/torch_task_parity.py): CE + InfoNCE + CT_Single, metrics="auc".

* the history epoch by epoch and the early-stop metric (1e-5);
* cv_pred and MolPredict's probabilities (1e-5 abs / 1e-4 rel);
* threshold.dat: 0.5 in both, which joblib reads from the port's file and
  the port reads from the JAX package's;
* the predict CSV: the same columns (prob_<col>, predict_<col>), labels
  and probabilities, and the same test_metric.result file;
* the JAX MolPredict on the port's experiment dir;
* load_threshold on files joblib and pickle write (floats, numpy scalars,
  arrays in C and Fortran order), and its refusal of any other class.
"""

import pickle

import joblib
import numpy as np
import pytest
import torch

from tests.torch_task_parity import (
    assert_csv_equal,
    assert_history_equal,
    assert_jax_predicts_port_experiment,
    assert_predictions_equal,
    assert_thresholds_equal,
    both_fits,
    one_thread,
)

# both classes in the 16 training and the 4 validation rows
LABELS = [1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    threads = one_thread()
    try:
        yield both_fits(tmp_path_factory.mktemp("classification"), "classification",
                        {"p_np": LABELS}, "auc")
    finally:
        torch.set_num_threads(threads)


def test_history_matches_jax(fits):
    assert_history_equal(fits, "auc")


def test_predictions_match_jax(fits):
    assert_predictions_equal(fits)
    assert fits["port"]["pred"].shape == (4, 1)
    assert ((fits["port"]["pred"] >= 0) & (fits["port"]["pred"] <= 1)).all()


def test_predict_csv_matches_jax(fits):
    assert_csv_equal(fits)
    assert {"prob_p_np", "predict_p_np"} <= set(fits["port"]["csv"].columns)


def test_threshold_dat_matches_jax(fits):
    assert assert_thresholds_equal(fits) == (0.5, 0.5)


def test_jax_molpredict_reads_the_port_experiment(fits, tmp_path):
    assert fits["port"]["config"]["task"] == fits["jax"]["config"]["task"] == "classification"
    assert_jax_predicts_port_experiment(fits, tmp_path)


@pytest.mark.parametrize("value", [0.5, np.float64(0.25), np.array([0.3, 0.7]),
                                   np.array([0.1, 0.2], np.float32),
                                   np.asfortranarray(np.arange(6.0).reshape(2, 3))],
                         ids=["float", "np_scalar", "array", "float32", "fortran"])
@pytest.mark.parametrize("writer", ["joblib", "pickle"])
def test_threshold_reader_reads_joblib_and_pickle(tmp_path, value, writer):
    from mmdti_tpu_torch.api.predict_api import load_threshold

    path = str(tmp_path / "threshold.dat")
    if writer == "joblib":
        joblib.dump(value, path)
    else:
        with open(path, "wb") as f:
            pickle.dump(value, f, protocol=4)
    got = load_threshold(path)
    np.testing.assert_array_equal(got, value)
    assert np.asarray(got).dtype == np.asarray(value).dtype


class _Call:
    def __reduce__(self):
        return (print, ("called",))


def test_threshold_reader_refuses_other_classes(tmp_path, capsys):
    from mmdti_tpu_torch.api.predict_api import load_threshold

    path = str(tmp_path / "threshold.dat")
    for value in (_Call(), {"a": np.array([0.5])}):
        joblib.dump(value, path)
        if isinstance(value, dict):
            # a dict of arrays is still only numpy classes: read
            np.testing.assert_array_equal(load_threshold(path)["a"], [0.5])
            continue
        with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
            load_threshold(path)
    assert "called" not in capsys.readouterr().out
