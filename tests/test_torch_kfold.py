"""mmdti_tpu_torch's k-fold cross-validation on the CPU against the JAX
package (the twin of tests/test_kfold.py):

* ``splits.Splitter``: the index arrays and the errors of scikit-learn's
  KFold, GroupKFold and StratifiedKFold, over sizes, seeds and layouts;
* ``MolTrain(kfold=2).fit(train)`` in both packages from the same initial
  weights (scaffold split, regression with the target scaler, InfoNCE and
  CT, fp32, the plain path, dropout 0): out-of-fold ``cv_pred``, each
  ``model_{fold}.ckpt``, the artifacts, and the fold-averaging
  ``MolPredict`` at the fit parity tolerance
  (tests/torch_task_parity.py); the port's ensemble is the mean of its
  folds, and ``MolServe(serve_folds="all")`` answers as ``MolPredict``;
* the port alone: a CV fit for each split method, the second fold
  replaying the first fold's train programs and sweep (and bit-equal to a
  fit of that fold from a fresh trainer), scaffold groups kept whole,
  ``fit(train, val)`` writing one fold, ``kfold=1`` without a validation
  set raising.

Torch runs on one thread.
"""

import os
import shutil
import warnings

import flax.serialization
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from mmdti_tpu.splits import Splitter as JaxSplitter
from mmdti_tpu_torch.splits import Splitter
from tests.conftest import SMALL_ARCH, SMILES_20
from tests.test_torch_fit import NO_DROPOUT, jax_parity_patches
from tests.torch_task_parity import PRED_ATOL, PRED_RTOL, one_thread

# ---- Splitter ------------------------------------------------------------------


def _layout(n, seed):
    rng = np.random.RandomState(seed + n)
    groups = np.asarray([f"g{i}" for i in rng.randint(0, max(3, n // 3), n)])
    return groups, rng.randint(0, 3, n)


def _both_splits(split_method, seed, n, **kw):
    out = []
    for cls in (Splitter, JaxSplitter):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                out.append(cls(split_method, seed).split(np.arange(n), **kw))
        except ValueError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("n", [7, 20, 101])
@pytest.mark.parametrize("method", ["random", "group", "scaffold", "stratified"])
def test_splitter_equals_scikit_learn(method, n, seed):
    groups, classes = _layout(n, seed)
    kw = {"random": {}, "group": {"group": groups}, "scaffold": {"group": groups},
          "stratified": {"target": classes}}[method]
    for k in (2, 3, 5):
        ours, theirs = _both_splits(f"{k}fold_{method}", seed, n, **kw)
        if isinstance(theirs, str):        # too few groups or class members
            assert ours == theirs
            continue
        assert len(ours) == len(theirs) == k
        for (tr_a, va_a), (tr_b, va_b) in zip(ours, theirs):
            np.testing.assert_array_equal(tr_a, tr_b)
            np.testing.assert_array_equal(va_a, va_b)


@pytest.mark.parametrize("case", [
    ("5fold_random", 3, {}),                                        # too few samples
    ("3fold_group", 10, {"group": np.asarray(["a", "b"] * 5)}),     # too few groups
    ("3fold_group", 10, {}),                                        # no groups
    ("3fold_stratified", 6, {"target": np.asarray([0, 0, 1, 1, 2, 2])}),
    ("3fold_stratified", 10, {"target": np.linspace(0, 1, 10)}),    # continuous
], ids=["samples", "groups", "no_groups", "members", "continuous"])
def test_splitter_errors_equal_scikit_learn(case):
    method, n, kw = case
    ours, theirs = _both_splits(method, 0, n, **kw)
    assert isinstance(ours, str) and ours == theirs


def test_stratified_ties_and_ordering():
    """Labels encoded by first appearance, the round-robin allocation of
    sorted labels and the per-class shuffle: uneven classes, and a class
    smaller than the folds (scikit-learn warns, both the same)."""
    y = np.asarray([2] * 11 + [0] * 5 + [7] * 2 + [0] * 4)
    ours, theirs = _both_splits("4fold_stratified", 3, len(y), target=y)
    for (tr_a, va_a), (tr_b, va_b) in zip(ours, theirs):
        np.testing.assert_array_equal(va_a, va_b)
        np.testing.assert_array_equal(tr_a, tr_b)


# ---- CV fits ---------------------------------------------------------------------

FIT = dict(task="regression", metrics="mse", epochs=2, learning_rate=1e-3, batch_size=8,
           early_stopping=5, smiles_col="smiles", target_cols=["measured"],
           using_infonce=True, using_ct=True, seed=42, compute_dtype="float32",
           mu_dtype="float32", use_pallas=False, **NO_DROPOUT)


@pytest.fixture(scope="module")
def threads():
    saved = one_thread()
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data_csv(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kfold")
    rng = np.random.RandomState(3)
    df = pd.DataFrame({"smiles": SMILES_20, "measured": rng.randn(len(SMILES_20)) * 2 + 1,
                       "site": [f"s{i % 5}" for i in range(len(SMILES_20))],
                       "active": (rng.rand(len(SMILES_20)) > 0.5).astype(int)})
    path = str(tmp / "train.csv")
    df.to_csv(path, index=False)
    return path, df


@pytest.fixture(scope="module")
def cv_fits(tmp_path_factory, data_csv, threads):
    """Both packages' kfold=2 scaffold CV fit and their MolPredict on the
    training CSV."""
    from mmdti_tpu import MolPredict as JaxPredict
    from mmdti_tpu import MolTrain as JaxTrain
    from mmdti_tpu_torch import MolPredict, MolTrain

    tmp = tmp_path_factory.mktemp("kfold_fits")
    csv = data_csv[0]
    out = {}
    with jax_parity_patches():
        for name, train_cls, pred_cls, dev in (("jax", JaxTrain, JaxPredict, {}),
                                               ("port", MolTrain, MolPredict,
                                                {"device": "cpu"})):
            exp = str(tmp / f"exp_{name}")
            clf = train_cls(save_path=exp, kfold=2, split="scaffold", **FIT, **dev).fit(csv)
            pred = pred_cls(load_model=exp, **dev).predict(csv)
            ckpts = []
            for fold in range(2):
                with open(os.path.join(exp, f"model_{fold}.ckpt"), "rb") as f:
                    ckpts.append(flax.serialization.msgpack_restore(f.read()))
            out[name] = dict(clf=clf, exp=exp, cv_pred=np.asarray(clf.cv_pred),
                             pred=np.asarray(pred), ckpts=ckpts)
    return out


def test_cv_out_of_fold_predictions_match_jax(cv_fits, data_csv):
    jx, pt = cv_fits["jax"]["cv_pred"], cv_fits["port"]["cv_pred"]
    assert pt.shape == jx.shape == (len(data_csv[1]), 1)
    np.testing.assert_allclose(pt, jx, atol=PRED_ATOL, rtol=PRED_RTOL)


def test_cv_fold_checkpoints_match_jax(cv_fits):
    """Each fold's weights at tests/test_torch_fit.py's fit tolerance
    (1e-4): Adam divides by the root of the second moment, so a
    coordinate whose gradients are near zero moves by up to the learning
    rate on a last-ulp difference."""
    for jx, pt in zip(cv_fits["jax"]["ckpts"], cv_fits["port"]["ckpts"]):
        assert jax.tree_util.tree_structure(pt["params"]) == jax.tree_util.tree_structure(
            jx["params"])
        for a, b in zip(jax.tree.leaves(jx["params"]), jax.tree.leaves(pt["params"])):
            np.testing.assert_allclose(b, a, atol=1e-4)
    # the two folds trained apart
    a, b = (jax.tree.leaves(c["params"]) for c in cv_fits["port"]["ckpts"])
    assert any(not np.array_equal(x, y) for x, y in zip(a, b))


def test_cv_artifacts_and_config_match_jax(cv_fits):
    from mmdti_tpu_torch.configs.config import load_yaml

    names = [sorted(os.listdir(cv_fits[k]["exp"])) for k in ("jax", "port")]
    assert names[0] == names[1]
    assert {"model_0.ckpt", "model_1.ckpt", "history_1.json", "target_scaler.ss"} <= set(
        names[1])
    for k in ("jax", "port"):
        cfg = load_yaml(os.path.join(cv_fits[k]["exp"], "config.yaml"))
        assert cfg["model_folds"] == 2 and cfg["split_method"] == "2fold_scaffold"


def test_cv_ensemble_predict_matches_jax(cv_fits):
    jx, pt = cv_fits["jax"]["pred"], cv_fits["port"]["pred"]
    assert pt.shape == jx.shape
    np.testing.assert_allclose(pt, jx, atol=PRED_ATOL, rtol=PRED_RTOL)


def _single_fold_dir(exp, fold, dst):
    from mmdti_tpu_torch.configs.config import load_yaml, save_yaml

    shutil.copytree(exp, dst)
    cfg = load_yaml(os.path.join(dst, "config.yaml"))
    cfg["model_folds"] = 1
    save_yaml(cfg, os.path.join(dst, "config.yaml"))
    if fold:
        os.replace(os.path.join(dst, f"model_{fold}.ckpt"), os.path.join(dst, "model_0.ckpt"))
    return dst


def test_port_ensemble_is_the_mean_of_its_folds(cv_fits, data_csv, tmp_path):
    from mmdti_tpu_torch import MolPredict

    exp, csv = cv_fits["port"]["exp"], data_csv[0]
    per_fold = [MolPredict(load_model=_single_fold_dir(exp, f, str(tmp_path / f"solo{f}")),
                           device="cpu").predict(csv) for f in (0, 1)]
    assert not np.allclose(per_fold[0], per_fold[1])
    np.testing.assert_allclose(cv_fits["port"]["pred"], (per_fold[0] + per_fold[1]) / 2,
                               rtol=1e-6, atol=1e-6)


def test_serve_all_folds_matches_molpredict(cv_fits, data_csv):
    from mmdti_tpu_torch import MolServe

    srv = MolServe(cv_fits["port"]["exp"], device="cpu", serve_folds="all")
    assert srv.serve_folds == 2
    out = srv.predict(list(data_csv[1]["smiles"]))["predict"]
    np.testing.assert_allclose(out, cv_fits["port"]["pred"], atol=PRED_ATOL, rtol=PRED_RTOL)


def test_second_fold_reuses_the_programs(cv_fits):
    """Both folds share one TrainPrograms and one validation sweep: the
    second fold resets the first's optimizer in place."""
    clf = cv_fits["port"]["clf"]
    sizes = {len(tr) // 8 for tr, _ in clf._cv_splits(2)}
    assert clf.trainer.programs_built == len(sizes) == 1
    assert len(clf.trainer._sweeps) == 1
    assert set(clf.trainer._slots) == {"train", "val"}


def _port_fit(exp, csv, **kw):
    from mmdti_tpu_torch import MolTrain

    return MolTrain(save_path=exp, device="cpu", **{**FIT, "epochs": 1, **kw}).fit(csv)


@pytest.mark.parametrize("split,extra", [
    ("random", {}),
    ("group", {"split_group_col": "site"}),
    ("stratified", {"task": "classification", "metrics": "auc", "target_cols": ["active"],
                    "threshold_search": True}),
], ids=["random", "group", "stratified"])
def test_port_cv_fit_each_split(data_csv, tmp_path, threads, split, extra):
    csv, df = data_csv
    clf = _port_fit(str(tmp_path / "exp"), csv, kfold=2, split=split, **extra)
    folds = clf._cv_splits(2)
    seen = np.sort(np.concatenate([va for _, va in folds]))
    np.testing.assert_array_equal(seen, np.arange(len(df)))
    assert clf.cv_pred.shape == (len(df), 1) and np.isfinite(clf.cv_pred).all()
    assert {"model_0.ckpt", "model_1.ckpt"} <= set(os.listdir(str(tmp_path / "exp")))
    if split == "group":
        sites = df["site"].to_numpy()
        for tr, va in folds:
            assert not set(sites[tr]) & set(sites[va])
    if split == "stratified":
        assert os.path.exists(str(tmp_path / "exp" / "threshold.dat"))
        assert ((clf.cv_pred >= 0) & (clf.cv_pred <= 1)).all()


def test_reused_fold_equals_a_fresh_fit(data_csv, tmp_path, threads, monkeypatch):
    """Fold 1 after fold 0 (reused programs, resident arrays refilled)
    trains bit for bit as fold 1 alone on a fresh trainer."""
    from mmdti_tpu_torch import MolTrain
    from mmdti_tpu_torch.train.checkpointing import load_checkpoint

    csv = data_csv[0]
    # dropout on: the generator goes back to its seed for the reused fold
    drop = dict(unimol_overrides={**SMALL_ARCH["unimol_overrides"], "dropout": 0.1})
    both = _port_fit(str(tmp_path / "both"), csv, kfold=2, **drop)
    second = both._cv_splits(2)[1]
    monkeypatch.setattr(MolTrain, "_cv_splits", lambda self, k: [second])
    alone = _port_fit(str(tmp_path / "alone"), csv, kfold=2, **drop)
    a = load_checkpoint(str(tmp_path / "both"), 1)["params"]
    b = load_checkpoint(str(tmp_path / "alone"), 0)["params"]
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(both.cv_pred[second[1]], alone.cv_pred[second[1]])


def test_scaffold_folds_keep_groups_intact(cv_fits):
    clf = cv_fits["port"]["clf"]
    groups = np.asarray(clf.data_train["group"])
    for tr, va in clf._cv_splits(2):
        assert not set(groups[tr]) & set(groups[va])


def test_explicit_val_trains_one_fold(data_csv, tmp_path, threads):
    from mmdti_tpu_torch import MolTrain
    from mmdti_tpu_torch.configs.config import load_yaml

    df = data_csv[1]
    train, val = str(tmp_path / "t.csv"), str(tmp_path / "v.csv")
    df.iloc[:16].to_csv(train, index=False)
    df.iloc[16:].to_csv(val, index=False)
    exp = str(tmp_path / "exp")
    MolTrain(save_path=exp, kfold=3, device="cpu", **{**FIT, "epochs": 1}).fit(train, val)
    assert os.path.exists(os.path.join(exp, "model_0.ckpt"))
    assert not os.path.exists(os.path.join(exp, "model_1.ckpt"))
    assert load_yaml(os.path.join(exp, "config.yaml"))["model_folds"] == 1


def test_missing_val_requires_kfold(tmp_path):
    from mmdti_tpu_torch import MolTrain

    with pytest.raises(ValueError, match="kfold"):
        MolTrain(save_path=str(tmp_path / "exp"), kfold=1, device="cpu", **FIT).fit(
            str(tmp_path / "missing.csv"))
