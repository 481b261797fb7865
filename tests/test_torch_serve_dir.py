"""mmdti_tpu_torch's MolServe over experiment dirs the JAX package writes,
on the CPU, against the JAX MolServe on the same dirs:

* a 2-fold CV regression dir (``MolTrain(kfold=2).fit(train)``): predict
  with serve_folds 1 and "all", embed, valid, batch invariance, within
  1e-5 abs / 1e-4 rel as tests/torch_task_parity.py holds predictions; the
  ensemble also equals the port's MolPredict on the same dir;
* a classification dir: threshold.dat, probabilities and labels;
* a JAX-written (joblib) StandardScaler, read without joblib;
* pair features built on the device (``device_pair_feats`` "device" or
  True) answering as the host-mode server does (1e-5);
* a mesh with a model axis (tensor parallelism) serving fold 0 as one
  shard does, and its fold ensemble refused; what is refused, with a
  pointer to ROADMAP.md: a scaler mode the port lacks;
  serve_folds outside 1..model_folds raises with JAX's message.

Both packages featurize through the port's numpy refinement; torch runs
on one thread.
"""

import os
import shutil

import joblib
import numpy as np
import pandas as pd
import pytest

from mmdti_tpu import MolServe as JaxServe
from mmdti_tpu import MolTrain as JaxTrain
from mmdti_tpu.data.scaler import TargetScaler as JaxScaler
from mmdti_tpu_torch import MolPredict, MolServe
from mmdti_tpu_torch.api.serve_api import resolve_pair_feats_mode
from mmdti_tpu_torch.configs.config import load_yaml, save_yaml
from tests.conftest import SMALL_ARCH, SMILES_20
from tests.torch_task_parity import PRED_ATOL, PRED_RTOL, one_thread

FIT = dict(epochs=1, learning_rate=1e-3, batch_size=8, early_stopping=5, smiles_col="smiles",
           seed=42, compute_dtype="float32", use_pallas=False, use_scaler=False, **SMALL_ARCH)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """Torch on one thread for the whole module; both packages featurize at
    their defaults."""
    import torch

    threads = one_thread()
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cv_exp(tmp_path_factory, torch_one_thread):
    rng = np.random.RandomState(3)
    tmp = tmp_path_factory.mktemp("serve_dir_cv")
    csv = str(tmp / "train.csv")
    pd.DataFrame({"smiles": SMILES_20,
                  "measured": rng.randn(len(SMILES_20)) * 2 + 1}).to_csv(csv, index=False)
    exp = str(tmp / "exp")
    JaxTrain(task="regression", metrics="mse", save_path=exp, target_cols=["measured"],
             kfold=2, **FIT).fit(csv)
    return exp, csv


@pytest.fixture(scope="module")
def clf_exp(tmp_path_factory, torch_one_thread):
    rng = np.random.RandomState(7)
    tmp = tmp_path_factory.mktemp("serve_dir_clf")
    df = pd.DataFrame({"smiles": SMILES_20,
                       "activity": (rng.rand(len(SMILES_20)) > 0.5).astype(int)})
    df.loc[:1, "activity"] = [0, 1]
    df.loc[16:17, "activity"] = [0, 1]
    train, val = str(tmp / "train.csv"), str(tmp / "val.csv")
    df.iloc[:16].to_csv(train, index=False)
    df.iloc[16:].to_csv(val, index=False)
    exp = str(tmp / "exp")
    JaxTrain(task="classification", metrics="auc", save_path=exp, target_cols=["activity"],
             **FIT).fit(train, val)
    return exp


@pytest.fixture(scope="module")
def jax_out(cv_exp):
    """The JAX MolServe's answers on the CV dir: predict with one fold and
    with both, and embed."""
    exp, _ = cv_exp
    one = JaxServe(exp)
    return {1: one.predict(SMILES_20), "all": JaxServe(exp, serve_folds="all").predict(SMILES_20),
            "embed": one.embed(SMILES_20)}


@pytest.fixture(scope="module")
def servers(cv_exp):
    exp, _ = cv_exp
    return {k: MolServe(exp, device="cpu", serve_folds=k) for k in (1, "all")}


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=PRED_ATOL, rtol=PRED_RTOL)


@pytest.mark.parametrize("folds", [1, "all"])
def test_predict_matches_jax(servers, jax_out, folds):
    got, want = servers[folds].predict(SMILES_20), jax_out[folds]
    assert servers[folds].serve_folds == (1 if folds == 1 else 2)
    assert got["target_cols"] == want["target_cols"] == ["measured"]
    assert got["proba"] is None and want["proba"] is None
    assert got["predict"].shape == (20, 1)
    _close(got["predict"], want["predict"])
    np.testing.assert_array_equal(got["valid"], want["valid"])


def test_ensemble_is_the_mean_of_its_folds(servers, jax_out):
    """The two folds differ, and "all" is their activated mean."""
    out_all = servers["all"].predict(SMILES_20)["predict"]
    fold0 = servers[1].predict(SMILES_20)["predict"]
    assert not np.allclose(out_all, fold0, atol=1e-4)
    fold1 = 2 * jax_out["all"]["predict"] - jax_out[1]["predict"]
    _close(out_all, (fold0 + fold1) / 2)


def test_embed_matches_jax(servers, jax_out):
    for folds in (1, "all"):   # fold 0's representations either way
        cls_r, pooled = servers[folds].embed(SMILES_20)
        assert cls_r.shape == (20, SMALL_ARCH["unimol_overrides"]["embed_dim"])
        _close(cls_r, jax_out["embed"][0])
        _close(pooled, jax_out["embed"][1])


def test_batch_invariance(servers, jax_out):
    srv = servers["all"]
    onebyone = np.concatenate([srv.predict(s)["predict"] for s in SMILES_20[:6]])
    _close(onebyone, jax_out["all"]["predict"][:6])


def test_valid_flag(servers):
    """A molecule that fell to zero coordinates is flagged, still predicted."""
    import copy

    srv = servers[1]
    srv.predict(["CCO"])
    fake = copy.deepcopy(srv._feat_cache["CCO"])
    fake["src_coord"] = np.zeros_like(np.asarray(fake["src_coord"]))
    srv._feat_cache["FAKEMOL"] = fake
    out = srv.predict(["CCO", "FAKEMOL"])
    assert out["valid"].tolist() == [True, False]
    assert np.isfinite(out["predict"]).all()


def test_ensemble_equals_molpredict(servers, cv_exp, tmp_path):
    exp, csv = cv_exp
    y_batch = MolPredict(load_model=exp, device="cpu").predict(csv)
    _close(servers["all"].predict(SMILES_20)["predict"], y_batch)


def test_classification_threshold_and_proba(clf_exp):
    from mmdti_tpu_torch.api.predict_api import load_threshold

    jx = JaxServe(clf_exp)
    srv = MolServe(clf_exp, device="cpu")
    assert os.path.exists(os.path.join(clf_exp, "threshold.dat"))
    np.testing.assert_array_equal(srv.threshold, jx.threshold)
    np.testing.assert_array_equal(
        srv.threshold, load_threshold(os.path.join(clf_exp, "threshold.dat")))
    got, want = srv.predict(SMILES_20), jx.predict(SMILES_20)
    assert got["proba"].shape == (20, 1)
    assert ((got["proba"] >= 0) & (got["proba"] <= 1)).all()
    _close(got["proba"], want["proba"])
    np.testing.assert_array_equal(got["predict"], (got["proba"] > srv.threshold).astype(int))
    np.testing.assert_array_equal(got["predict"], want["predict"])


@pytest.mark.parametrize("kw", [dict(mesh_shape=(1, 2))])
def test_refusals_point_to_the_roadmap(servers, cv_exp, kw):
    """A model axis serves fold 0 of the CV dir in two tensor-parallel
    shards, as the one-shard server does (on the plain path: SMALL_ARCH's
    2 heads a shard are below the fused gbf kernel's gate, which raises);
    its fold ensemble still refuses (tests/test_kfold.py's JAX refusal)."""
    with pytest.raises(ValueError, match="gbf kernel's gate"):
        MolServe(cv_exp[0], device="cpu", **kw)
    srv = MolServe(cv_exp[0], device="cpu", use_kernels=False, **kw)
    assert srv.mesh.shape == {"data": 1, "model": 2} and srv.serve_folds == 1
    _close(srv.predict(SMILES_20)["predict"], servers[1].predict(SMILES_20)["predict"])
    with pytest.raises(ValueError, match="tensor-parallel"):
        MolServe(cv_exp[0], device="cpu", serve_folds="all", **kw)


@pytest.mark.parametrize("value", ["device", True])
def test_device_pair_feats_serves_as_host(servers, cv_exp, value):
    """Requests ship coordinates and the forward builds the pair arrays;
    the answers are the host-mode server's within 1e-5."""
    srv = MolServe(cv_exp[0], device="cpu", device_pair_feats=value)
    assert srv.pair_mode == "device" and servers[1].pair_mode == "host"
    arrays, _ = srv._collate(srv._featurize(SMILES_20[:3]))
    assert "src_coord" in arrays and "src_distance" not in arrays
    got, want = srv.predict(SMILES_20), servers[1].predict(SMILES_20)
    np.testing.assert_allclose(got["predict"], want["predict"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["valid"], want["valid"])


@pytest.mark.parametrize("folds", [0, 3])
def test_serve_folds_out_of_range(cv_exp, folds):
    msg = f"serve_folds={folds!r} but the experiment dir has 2 fold checkpoint"
    with pytest.raises(ValueError, match=msg):
        MolServe(cv_exp[0], device="cpu", serve_folds=folds)


def test_host_pair_feature_spellings():
    for v in ("auto", "host", "false", False, None):
        assert resolve_pair_feats_mode(v) == "host"
    with pytest.raises(ValueError):
        resolve_pair_feats_mode("sideways")


def test_jax_joblib_scaler_refused(cv_exp, tmp_path):
    """A JAX-written (joblib) StandardScaler and MinMaxScaler are read and
    serve as the JAX MolServe does; a scikit-learn class that no mode
    writes (Binarizer) is refused, naming it."""
    exp = str(tmp_path / "exp_scaled")
    shutil.copytree(cv_exp[0], exp)
    cfg = load_yaml(os.path.join(exp, "config.yaml"))
    cfg.update(use_scaler=True, target_normalize="standard")
    save_yaml(cfg, os.path.join(exp, "config.yaml"))
    JaxScaler("standard", "regression").fit(np.linspace(-3, 5, 20).reshape(-1, 1), exp)
    assert joblib.load(os.path.join(exp, "target_scaler.ss")) is not None
    got = MolServe(exp, device="cpu").predict(SMILES_20)
    want = JaxServe(exp).predict(SMILES_20)
    np.testing.assert_allclose(got["predict"], want["predict"], atol=PRED_ATOL, rtol=PRED_RTOL)
    JaxScaler("minmax", "regression").fit(np.linspace(-3, 5, 20).reshape(-1, 1), exp)
    cfg["target_normalize"] = "minmax"
    save_yaml(cfg, os.path.join(exp, "config.yaml"))
    got = MolServe(exp, device="cpu").predict(SMILES_20)
    want = JaxServe(exp).predict(SMILES_20)
    np.testing.assert_allclose(got["predict"], want["predict"], atol=PRED_ATOL, rtol=PRED_RTOL)
    from sklearn.preprocessing import Binarizer

    joblib.dump(Binarizer().fit(np.zeros((2, 1))), os.path.join(exp, "target_scaler.ss"))
    with pytest.raises(NotImplementedError, match="Binarizer"):
        MolServe(exp, device="cpu")
