"""target_scaler.ss between the two packages on the CPU (ROADMAP §3.1):

* the port writes the pickle ``joblib.dump`` writes of scikit-learn's
  StandardScaler and RobustScaler (a list of them for
  multilabel_regression), without either package: joblib restores
  scikit-learn objects that transform as the port does;
* the port reads the JAX package's joblib scalers, and its own earlier
  ``.npz``; a scikit-learn class no mode writes raises, naming it;
* experiment dirs: the JAX MolPredict on the port's regression and
  multilabel_regression dirs fitted with ``use_scaler=True`` gives the
  port's predictions, and the port's MolPredict and MolServe on a dir
  whose config and scaler the JAX package wrote give the JAX MolPredict's,
  at PRED_ATOL/PRED_RTOL (tests/torch_task_parity.py).

Torch runs on one thread.
"""

import os
import shutil
import warnings

import joblib
import numpy as np
import pandas as pd
import pytest
import torch

from mmdti_tpu.configs.config import save_yaml as jax_save_yaml
from mmdti_tpu.data.scaler import TargetScaler as JaxScaler
from mmdti_tpu_torch.configs.config import load_yaml
from mmdti_tpu_torch.data.scaler import ARTIFACT_NAME, TargetScaler
from tests.conftest import SMALL_ARCH, SMILES_20
from tests.test_torch_fit import jax_parity_patches
from tests.torch_task_parity import PRED_ATOL, PRED_RTOL, one_thread

TARGETS = {"regression": np.random.RandomState(0).randn(40, 1) * 3 + 2,
           "multilabel_regression": np.random.RandomState(1).randn(40, 3) ** 3}
TARGETS["multilabel_regression"][[2, 7], [0, 2]] = np.nan


def _joblib_load(path):
    with warnings.catch_warnings():
        # scikit-learn warns that the pickle names no version of its own
        warnings.simplefilter("ignore")
        return joblib.load(path)


@pytest.mark.parametrize("method", ["standard", "robust"])
@pytest.mark.parametrize("task", ["regression", "multilabel_regression"])
def test_joblib_restores_the_port_scaler(tmp_path, task, method):
    from sklearn.preprocessing import RobustScaler, StandardScaler

    ours = TargetScaler(method, task)
    ours.fit(TARGETS[task], str(tmp_path))
    restored = _joblib_load(str(tmp_path / ARTIFACT_NAME))
    cls = StandardScaler if method == "standard" else RobustScaler
    objs = restored if task == "multilabel_regression" else [restored]
    assert isinstance(restored, list) == (task == "multilabel_regression")
    assert all(type(o) is cls for o in objs)
    theirs = JaxScaler(method, task)
    theirs.scaler = restored
    x = np.random.RandomState(2).randn(6, TARGETS[task].shape[1])
    np.testing.assert_allclose(theirs.transform(x), ours.transform(x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(theirs.inverse_transform(x), ours.inverse_transform(x),
                               rtol=1e-12, atol=1e-12)
    # the fitted attributes scikit-learn would have
    fitted = JaxScaler(method, task)
    fitted.fit(TARGETS[task])
    for got, want in zip(objs, fitted.scaler if isinstance(fitted.scaler, list)
                         else [fitted.scaler]):
        for k, v in vars(want).items():
            if k.endswith("_") and k != "n_samples_seen_":
                np.testing.assert_allclose(getattr(got, k), v, rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("method", ["standard", "robust", "auto"])
@pytest.mark.parametrize("task", ["regression", "multilabel_regression"])
def test_port_reads_the_jax_scaler(tmp_path, task, method):
    theirs = JaxScaler(method, task)
    theirs.fit(TARGETS[task], str(tmp_path))
    ours = TargetScaler(method, task, str(tmp_path))
    x = np.random.RandomState(3).randn(6, TARGETS[task].shape[1])
    np.testing.assert_allclose(ours.transform(x), theirs.transform(x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours.inverse_transform(x), theirs.inverse_transform(x),
                               rtol=1e-12, atol=1e-12)


def test_port_reads_its_earlier_npz(tmp_path):
    path = str(tmp_path / ARTIFACT_NAME)
    with open(path, "wb") as f:
        np.savez(f, method=np.asarray(["standard"]), center=np.asarray([1.5]),
                 scale=np.asarray([2.0]))
    ours = TargetScaler("standard", "regression", str(tmp_path))
    np.testing.assert_array_equal(ours.transform(np.asarray([[3.5]])), [[1.0]])


@pytest.mark.parametrize("method,name", [("minmax", "MinMaxScaler"), ("maxabs", "MaxAbsScaler"),
                                         ("quantile", "QuantileTransformer")])
def test_other_jax_scaler_modes_raise(tmp_path, method, name):
    """The JAX package's file of each of these modes is read and transforms
    as the JAX scaler does; a scikit-learn class that no mode writes
    (Binarizer) still raises, naming it."""
    from sklearn.preprocessing import Binarizer

    theirs = JaxScaler(method, "regression")
    theirs.fit(TARGETS["regression"], str(tmp_path))
    ours = TargetScaler(method, "regression", str(tmp_path))
    assert type(ours.scaler[0]).__name__ == f"_{name}"
    x = np.random.RandomState(3).randn(6, 1)
    np.testing.assert_allclose(ours.transform(x), theirs.transform(x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours.inverse_transform(x), theirs.inverse_transform(x),
                               rtol=1e-12, atol=1e-12)
    joblib.dump(Binarizer().fit(TARGETS["regression"]), str(tmp_path / ARTIFACT_NAME))
    with pytest.raises(NotImplementedError, match="Binarizer"):
        TargetScaler(method, "regression", str(tmp_path))


def test_unknown_class_in_the_scaler_file_is_not_called(tmp_path, capsys):
    class Call:
        def __reduce__(self):
            return (print, ("called",))

    joblib.dump(Call(), str(tmp_path / ARTIFACT_NAME))
    with pytest.raises(NotImplementedError, match="builtins.print"):
        TargetScaler("standard", "regression", str(tmp_path))
    assert "called" not in capsys.readouterr().out


# ---- experiment dirs ---------------------------------------------------------------

FIT = dict(epochs=1, learning_rate=1e-3, batch_size=8, smiles_col="smiles", seed=42,
           compute_dtype="float32", use_pallas=False, use_scaler=True, device="cpu",
           **SMALL_ARCH)


@pytest.fixture(scope="module")
def port_dirs(tmp_path_factory):
    """The port's regression and multilabel_regression dirs (default
    use_scaler=True: 'auto' picks standard or robust), their validation
    CSV and the port's predictions."""
    from mmdti_tpu_torch import MolPredict, MolTrain

    saved = one_thread()
    tmp = tmp_path_factory.mktemp("scaler_dirs")
    rng = np.random.RandomState(5)
    df = pd.DataFrame({"smiles": SMILES_20, "y": rng.randn(20) * 4 + 10,
                       "a": rng.randn(20), "b": np.exp(rng.randn(20) * 3)})
    df.loc[4, "a"] = np.nan
    train, val = str(tmp / "train.csv"), str(tmp / "val.csv")
    df.iloc[:16].to_csv(train, index=False)
    df.iloc[16:].to_csv(val, index=False)
    out = {}
    for task, cols, metrics in (("regression", ["y"], "mse"),
                                ("multilabel_regression", ["a", "b"], "mae")):
        exp = str(tmp / task)
        MolTrain(task=task, metrics=metrics, target_cols=cols, save_path=exp,
                 **FIT).fit(train, val)
        out[task] = (exp, np.asarray(MolPredict(load_model=exp, device="cpu").predict(val)))
    torch.set_num_threads(saved)
    return out, val


@pytest.mark.parametrize("task", ["regression", "multilabel_regression"])
def test_jax_molpredict_reads_the_port_dir(port_dirs, task):
    from mmdti_tpu import MolPredict as JaxPredict

    dirs, val = port_dirs
    exp, ours = dirs[task]
    assert not open(os.path.join(exp, ARTIFACT_NAME), "rb").read(2) == b"PK"
    with jax_parity_patches(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = np.asarray(JaxPredict(load_model=exp).predict(val))
    assert theirs.shape == ours.shape
    np.testing.assert_allclose(ours, theirs, atol=PRED_ATOL, rtol=PRED_RTOL)


def test_port_reads_a_jax_written_dir(port_dirs, tmp_path):
    """config.yaml through the JAX writer and a joblib scaler the JAX
    package fitted (on other values, so the scale matters); the port's
    MolPredict and MolServe give the JAX MolPredict's predictions."""
    from mmdti_tpu import MolPredict as JaxPredict
    from mmdti_tpu_torch import MolPredict, MolServe

    dirs, val = port_dirs
    exp = str(tmp_path / "jax_written")
    shutil.copytree(dirs["regression"][0], exp)
    cfg = load_yaml(os.path.join(exp, "config.yaml")).to_dict()
    cfg["target_normalize"] = "robust"
    jax_save_yaml(cfg, os.path.join(exp, "config.yaml"))
    JaxScaler("robust", "regression").fit(np.linspace(-50, 70, 33).reshape(-1, 1) ** 3, exp)
    assert type(_joblib_load(os.path.join(exp, ARTIFACT_NAME))).__name__ == "RobustScaler"
    with jax_parity_patches():
        theirs = np.asarray(JaxPredict(load_model=exp).predict(val))
        saved = one_thread()
        ours = np.asarray(MolPredict(load_model=exp, device="cpu").predict(val))
        served = MolServe(exp, device="cpu").predict(list(pd.read_csv(val)["smiles"]))
        torch.set_num_threads(saved)
    assert np.abs(theirs - dirs["regression"][1]).max() > 1.0    # the scaler moved them
    np.testing.assert_allclose(ours, theirs, atol=PRED_ATOL, rtol=PRED_RTOL)
    np.testing.assert_allclose(served["predict"], theirs, atol=PRED_ATOL, rtol=PRED_RTOL)
