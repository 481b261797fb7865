"""The fit-and-predict parity harness of the task test files
(tests/test_torch_fit_<task>.py): ``MolTrain.fit(train, val)`` ->
``MolPredict.predict(val)`` in both packages on the 20-SMILES split of
tests/test_torch_fit.py (16 train, 4 val), SMALL_ARCH, fp32 (Adam's first
moment too), the plain path, every dropout 0, InfoNCE and CT on, 2 epochs
of batch 8, the port starting from the JAX initial parameters, each
package with its default dispatch (the resident feed and K steps a
dispatch).  Not a test module itself: the task files share it.
"""

import json
import os

import joblib
import numpy as np
import pandas as pd
import torch

from tests.conftest import SMILES_20
from tests.test_torch_fit import NO_DROPOUT, jax_parity_patches

# cv_pred and predictions, as tests/test_torch_fit.py holds regression
PRED_ATOL, PRED_RTOL = 1e-5, 1e-4
HIST_RTOL = 1e-5
HIST_KEYS = ("val_loss", "train_loss", "m_loss", "infonce_loss", "ct_loss")


def one_thread():
    """Each fit is many tiny operations: a thread pool each slows them
    down many times over beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    return threads


def task_csvs(tmp, columns):
    """train.csv (the first 16 SMILES) and val.csv (the last 4) under tmp,
    with the target columns ``columns`` (name -> 20 values)."""
    df = pd.DataFrame({"smiles": SMILES_20, **columns})
    train_p, val_p = str(tmp / "train.csv"), str(tmp / "val.csv")
    df.iloc[:16].to_csv(train_p, index=False)
    df.iloc[16:].to_csv(val_p, index=False)
    return train_p, val_p


def fit_kwargs(task, target_cols, metrics, exp, **extra):
    return dict(task=task, epochs=2, learning_rate=1e-3, batch_size=8, early_stopping=5,
                metrics=metrics, smiles_col="smiles", save_path=exp, target_cols=target_cols,
                using_infonce=True, using_ct=True, seed=42, compute_dtype="float32",
                mu_dtype="float32", use_pallas=False, **NO_DROPOUT, **extra)


def both_fits(tmp, task, columns, metrics, random_init_only=False, **extra):
    """Both packages' fit -> predict on the same data and initial weights
    (with ``random_init_only``, the same random draw under each package's
    own pretrained ingestion: test_torch_fit.py::jax_parity_patches).
    Returns {"jax"|"port": {exp, cv_pred, pred, hist, out, csv, config}}."""
    from mmdti_tpu import MolPredict as JaxPredict
    from mmdti_tpu import MolTrain as JaxTrain
    from mmdti_tpu_torch import MolPredict, MolTrain
    from mmdti_tpu_torch.configs.config import load_yaml

    train_p, val_p = task_csvs(tmp, columns)
    target_cols = list(columns)
    out = {"val": val_p}
    with jax_parity_patches(random_init_only):
        for name, train_cls, pred_cls, dev in (("jax", JaxTrain, JaxPredict, {}),
                                               ("port", MolTrain, MolPredict,
                                                {"device": "cpu"})):
            exp = str(tmp / f"exp_{name}")
            fit = train_cls(**fit_kwargs(task, target_cols, metrics, exp, **extra),
                            **dev).fit(train_p, val_p)
            pred_dir = str(tmp / f"out_{name}")
            pred = pred_cls(load_model=exp, **dev).predict(val_p, save_path=pred_dir)
            with open(os.path.join(exp, "history_0.json")) as f:
                hist = json.load(f)
            out[name] = dict(exp=exp, cv_pred=np.asarray(fit.cv_pred), pred=np.asarray(pred),
                             hist=hist, out=pred_dir,
                             csv=pd.read_csv(os.path.join(pred_dir, "val.predict.0.csv")),
                             config=load_yaml(os.path.join(exp, "config.yaml")).to_dict())
    return out


def assert_history_equal(fits, metric):
    """Epoch by epoch the losses and the early-stop metric, and the same
    best epoch."""
    jx, pt = fits["jax"]["hist"], fits["port"]["hist"]
    assert len(jx) == len(pt) == 2
    key = f"val_{metric}"
    for a, b in zip(jx, pt):
        assert set(a) == set(b)
        for k in (*HIST_KEYS, key):
            np.testing.assert_allclose(b[k], a[k], rtol=HIST_RTOL, err_msg=k)
    assert best_epoch(jx, key) == best_epoch(pt, key)


def best_epoch(hist, key):
    better = (lambda a, b: a <= b) if "loss" in key else (lambda a, b: a >= b)
    best, at = None, None
    for row in hist:
        if best is None or better(row[key], best):
            best, at = row[key], row["epoch"]
    return at


def assert_predictions_equal(fits):
    jx, pt = fits["jax"], fits["port"]
    for k in ("cv_pred", "pred"):
        assert pt[k].shape == jx[k].shape, k
        np.testing.assert_allclose(pt[k], jx[k], atol=PRED_ATOL, rtol=PRED_RTOL, err_msg=k)


def assert_csv_equal(fits):
    """The same predict-CSV columns; equal labels, probabilities within
    the prediction tolerance; the same metric file."""
    a, b = fits["port"]["csv"], fits["jax"]["csv"]
    assert list(a.columns) == list(b.columns)
    for col in a.columns:
        if col.startswith("prob_"):
            np.testing.assert_allclose(a[col], b[col], atol=PRED_ATOL, rtol=PRED_RTOL,
                                       err_msg=col)
        else:
            pd.testing.assert_series_equal(a[col], b[col])
    assert sorted(os.listdir(fits["port"]["out"])) == sorted(os.listdir(fits["jax"]["out"]))


def assert_thresholds_equal(fits):
    """threshold.dat: joblib reads the port's, the port reads the JAX
    package's, and both hold the same value."""
    from mmdti_tpu_torch.api.predict_api import load_threshold

    ours = os.path.join(fits["port"]["exp"], "threshold.dat")
    theirs = os.path.join(fits["jax"]["exp"], "threshold.dat")
    a, b = joblib.load(ours), load_threshold(theirs)
    np.testing.assert_array_equal(load_threshold(ours), a)
    np.testing.assert_array_equal(joblib.load(theirs), b)
    assert np.shape(a) == np.shape(b)
    np.testing.assert_allclose(a, b, atol=PRED_ATOL, rtol=PRED_RTOL)
    return a, b


def assert_jax_predicts_port_experiment(fits, tmp):
    """The JAX MolPredict on the port's experiment dir gives the port
    MolPredict's predictions and columns."""
    from mmdti_tpu import MolPredict as JaxPredict

    out = str(tmp / "jax_on_port")
    pred = JaxPredict(load_model=fits["port"]["exp"]).predict(fits["val"], save_path=out)
    np.testing.assert_allclose(pred, fits["port"]["pred"], atol=PRED_ATOL, rtol=PRED_RTOL)
    csv = pd.read_csv(os.path.join(out, "val.predict.0.csv"))
    assert list(csv.columns) == list(fits["port"]["csv"].columns)
