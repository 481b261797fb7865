"""mmdti_tpu_torch's fit-and-predict path on the CPU against the JAX package.

* The host modules on the same numpy inputs: FDS (1e-6), target scaler
  (auto/standard/robust, 1e-6: scikit-learn sums in another order; every
  mode at 1e-12 in tests/test_torch_scaler_modes.py), a power_trans fit
  -> predict against the JAX package's, normalizer failing both fits, sample
  weights and scaffold/random splits (exact), the CSV reader and the
  synthetic protocol dataset (exact).
* The artifact codecs both ways: config.yaml (PyYAML reads the port's,
  the port reads PyYAML's) and model_0.ckpt (flax restores the port's, the
  port restores flax's, exactly; the bytes are equal).
* The slice as a whole: ``MolTrain.fit(train, val)`` -> ``MolPredict`` in
  both packages on the 20-SMILES split of tests/test_end_to_end.py, small
  arch, fp32 (Adam's first moment too), the plain path, every dropout 0
  (the InfoNCE query dropout too), FDS, sample weights, InfoNCE and CT on, 2 epochs of batch 8, the
  port starting from the JAX initial parameters.  Both packages run their
  defaults: the device-resident feed ('auto' engages it on this data) and
  4 steps per dispatch (the JAX package's feed: the whole epoch).
* The fit path runs with jax, flax, pandas, scikit-learn, joblib, PyYAML,
  msgpack and RDKit blocked: a regression fit, and a classification fit
  with its threshold search.
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import textwrap
import warnings

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import mmdti_tpu.models.mm_model as jax_mm
import mmdti_tpu.train.nnmodel as jax_nnmodel
import mmdti_tpu_torch.models.mm_model as port_mm
import mmdti_tpu_torch.train.nnmodel as port_nnmodel
from mmdti_tpu.configs.architectures import FDSConfig as JaxFDSConfig
from mmdti_tpu.configs.config import load_yaml as jax_load_yaml
from mmdti_tpu.configs.config import save_yaml as jax_save_yaml
from mmdti_tpu.data.reader import MolDataReader as JaxReader
from mmdti_tpu.data.scaler import TargetScaler as JaxScaler
from mmdti_tpu.data.weights import compute_sample_weights as jax_weights
from mmdti_tpu.losses import fds as jax_fds
from mmdti_tpu.splits import random_scaffold_split as jax_scaffold_split
from mmdti_tpu.splits import random_split as jax_random_split
from mmdti_tpu_torch.configs.architectures import FDSConfig
from mmdti_tpu_torch.configs.config import Config, load_yaml, save_yaml
from mmdti_tpu_torch.data.reader import MolDataReader, read_csv, write_csv
from mmdti_tpu_torch.data.scaler import TargetScaler
from mmdti_tpu_torch.data.weights import compute_sample_weights
from mmdti_tpu_torch.losses import fds
from mmdti_tpu_torch.models.convert import flax_params_to_state_dict
from mmdti_tpu_torch.splits import random_scaffold_split, random_split
from mmdti_tpu_torch.train import checkpointing as ckpt
from tests.conftest import SMALL_ARCH, SMILES_20

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- host modules -------------------------------------------------------------

def _fds_inputs(seed=0, n=48, f=16):
    rng = np.random.RandomState(seed)
    return rng.randn(n, f).astype(np.float32), (rng.randn(n, 1) * 1.5).astype(np.float32)


def _jax_cfg(**kw):
    return JaxFDSConfig(**{"feature_dim": 16, "bucket_num": 8, **kw})


def _port_cfg(**kw):
    return FDSConfig(**{"feature_dim": 16, "bucket_num": 8, **kw})


@pytest.mark.parametrize("kernel", ["gaussian", "triang", "laplace"])
def test_fds_window_and_buckets_equal_jax(kernel):
    np.testing.assert_array_equal(fds.fds_kernel_window(kernel, 5, 1.0),
                                  jax_fds.fds_kernel_window(kernel, 5, 1.0))
    raw = np.random.RandomState(1).randn(100) * 3 + 2
    assert fds.fds_bucket_params(raw, 8) == jax_fds.fds_bucket_params(raw, 8)
    assert fds.fds_bucket_params(raw, 8, False) == jax_fds.fds_bucket_params(raw, 8, False)


def test_fds_epochs_and_smoothing_match_jax():
    """Three epoch updates (running stats EMA, the last-epoch roll, bucket
    smoothing, the witness rule at both edges) and the smoothing of a batch
    after each: 1e-6 (sums in another order)."""
    bucket = (-1.5, 0.4)
    win = fds.fds_kernel_window("gaussian", 5, 1.0)
    js, ts = jax_fds.init_fds_state(_jax_cfg()), fds.init_fds_state(_port_cfg())
    for epoch in range(3):
        feats, labels = _fds_inputs(epoch)
        js = jax_fds.fds_epoch_update(js, jnp.asarray(feats), jnp.asarray(labels),
                                      jnp.asarray(epoch, jnp.float32), *bucket, win, _jax_cfg())
        ts = fds.fds_epoch_update(ts, torch.from_numpy(feats), torch.from_numpy(labels),
                                  float(epoch), *bucket, win, _port_cfg())
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=k)
        f2, l2 = _fds_inputs(10 + epoch, n=12)
        want = jax_fds.fds_smooth(js, jnp.asarray(f2), jnp.asarray(l2), float(epoch + 1),
                                  *bucket, _jax_cfg())
        got = fds.fds_smooth(ts, torch.from_numpy(f2), torch.from_numpy(l2), float(epoch + 1),
                             *bucket, _port_cfg())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("method,values", [
    ("auto", np.random.RandomState(0).randn(50, 1) * 2 + 1),
    ("auto", np.concatenate([np.zeros((60, 1)), [[1e4]]])),     # skewed: robust
    ("standard", np.random.RandomState(1).randn(30, 1)),
    ("robust", np.random.RandomState(2).randn(31, 1) ** 3),
])
def test_target_scaler_matches_jax(tmp_path, method, values):
    ours, theirs = TargetScaler(method, "regression"), JaxScaler(method, "regression")
    ours.fit(values, str(tmp_path))
    theirs.fit(values)
    x = np.random.RandomState(3).randn(7, 1)
    np.testing.assert_allclose(ours.transform(x), theirs.transform(x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.inverse_transform(x), theirs.inverse_transform(x),
                               rtol=1e-6, atol=1e-6)
    reloaded = TargetScaler(method, "regression", str(tmp_path))
    np.testing.assert_array_equal(reloaded.transform(x), ours.transform(x))


def test_scaler_modes_not_ported_raise():
    """Every mode of the JAX package is ported (tests/test_torch_scaler_modes.py);
    a mode neither package has raises in both."""
    with pytest.raises(ValueError, match="Unknown scaler method"):
        TargetScaler("zscore", "regression").fit(np.arange(5.0))
    with pytest.raises(KeyError):
        JaxScaler("zscore", "regression").fit(np.arange(5.0))


@pytest.mark.parametrize("lds", [False, True])
def test_sample_weights_equal_jax(lds):
    t = np.random.RandomState(4).randn(64, 1) * 2
    np.testing.assert_array_equal(compute_sample_weights(t, lds=lds, max_bin=10),
                                  jax_weights(t, lds=lds, max_bin=10))


@pytest.fixture(scope="module")
def synthetic_csvs(tmp_path_factory):
    from finetune import make_synthetic_dataset as jax_make
    from mmdti_tpu_torch.finetune import make_synthetic_dataset

    d = tmp_path_factory.mktemp("synthetic")
    ours, theirs = str(d / "port.csv"), str(d / "jax.csv")
    make_synthetic_dataset(ours, n=120, seed=3)
    jax_make(theirs, n=120, seed=3)
    return ours, theirs


def test_synthetic_dataset_equals_jax(synthetic_csvs):
    ours, theirs = synthetic_csvs
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("seed", [0, 4])
def test_splits_equal_jax(synthetic_csvs, seed):
    path = synthetic_csvs[0]
    df = pd.read_csv(path)
    for ours, theirs in ((random_scaffold_split(path, seed), jax_scaffold_split(path, seed)),
                         (random_split(path, seed), jax_random_split(path, seed))):
        for part, want in zip(ours, theirs):
            assert list(part["smiles"]) == list(want["smiles"])
            # pandas' C parser may round a decimal one ulp away from the
            # correctly rounded float() the port's csv reader takes
            np.testing.assert_allclose(part["measured"], want["measured"].to_numpy(),
                                       rtol=0, atol=1e-15)
    assert len(df) == 120


def test_reader_equals_jax(tmp_path):
    path = str(tmp_path / "r.csv")
    y = np.random.RandomState(5).randn(20)
    y[3] = 40.0                                   # a 3-sigma outlier
    pd.DataFrame({"smiles": SMILES_20[:19] + ["C1CC"], "measured": y}).to_csv(path, index=False)
    kw = dict(task="regression", target_cols=["measured"], smiles_col="smiles",
              anomaly_clean=True)
    ours, theirs = MolDataReader().read_data(path, True, **kw), JaxReader().read_data(path, True,
                                                                                      **kw)
    assert len(ours["smiles"]) == 18                # invalid SMILES and the outlier dropped
    for k in ("smiles", "scaffolds", "num_classes", "target_cols", "group"):
        assert ours[k] == theirs[k], k
    # the CSV parse: one ulp at most (pandas' C parser, see test_splits_equal_jax)
    np.testing.assert_allclose(ours["raw_target"], theirs["raw_target"], rtol=0, atol=1e-15)
    # predict time: an invalid SMILES raises, a missing target column
    # becomes the -1.0 placeholder
    with pytest.raises(ValueError, match="illegal"):
        MolDataReader().read_data(path, False, **kw)
    p = MolDataReader().read_data({"smiles": SMILES_20[:3]}, False, task="regression",
                                  target_cols=["other"], smiles_col="smiles")
    assert p["raw_target"] == [[-1.0]] * 3


def test_csv_roundtrip_keeps_nan_and_types(tmp_path):
    path = str(tmp_path / "t.csv")
    table = {"s": np.asarray(["a", "b,c", "d"], object), "x": np.asarray([1.5, np.nan, -2.0]),
             "i": np.asarray([1, 2, 3])}
    write_csv(table, path)
    back = read_csv(path)
    assert list(back["s"]) == ["a", "b,c", "d"] and back["i"].dtype == np.int64
    np.testing.assert_array_equal(back["x"], table["x"])
    pdf = pd.read_csv(path)
    np.testing.assert_array_equal(pdf["x"].to_numpy(), table["x"])


# ---- codecs -------------------------------------------------------------------

CONFIG = {"task": "regression", "learning_rate": 1e-05, "warmup_ratio": 0.03,
          "target_cols": "measured", "smiles_col": "smiles", "raw_data": None,
          "use_pallas": False, "epochs": 2, "fds_col_data": "", "name": "1e-05",
          "unimol_overrides": {"encoder_layers": 2, "dropout": 0.0, "pair_dtype": "float32"},
          "chemberta_overrides": {}, "mesh_shape": None, "ids": [1, 2], "flag": "true",
          "note": "two\nlines, a tab\tand é", "long": "wrapped words " * 12 + "\nnext " * 20}


def test_config_yaml_both_ways(tmp_path):
    ours, theirs = str(tmp_path / "port.yaml"), str(tmp_path / "jax.yaml")
    save_yaml(Config(CONFIG), ours)
    jax_save_yaml(CONFIG, theirs)
    with open(ours) as f:
        assert yaml.safe_load(f) == CONFIG
    assert load_yaml(theirs).to_dict() == CONFIG
    assert jax_load_yaml(ours).to_dict() == CONFIG


def _flax_tree():
    rng = np.random.RandomState(6)
    return {"params": {"encoder": {"layers_0": {"in_proj": {
                "kernel": rng.randn(8, 24).astype(np.float32),
                "bias": rng.randn(24).astype(np.float32)}}},
            "gbf": {"means": {"embedding": rng.randn(1, 16).astype(np.float32)}}},
            "fds": {"epoch": np.asarray(2.0, np.float32),
                    "running_mean": rng.randn(8, 16).astype(np.float32)}}


def test_checkpoint_codec_both_ways(tmp_path):
    tree = _flax_tree()
    ckpt.save_checkpoint(str(tmp_path), 0, tree["params"], tree["fds"])
    with open(ckpt.checkpoint_path(str(tmp_path), 0), "rb") as f:
        blob = f.read()
    assert blob == flax.serialization.msgpack_serialize(tree)

    def equal(a, b):
        assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)

    equal(flax.serialization.msgpack_restore(blob), tree)
    equal(ckpt.msgpack_restore(flax.serialization.msgpack_serialize(tree)), tree)
    equal(ckpt.load_checkpoint(str(tmp_path), 0), tree)


# ---- the slice as a whole -----------------------------------------------------

NO_DROPOUT = dict(
    unimol_overrides=SMALL_ARCH["unimol_overrides"],
    chemberta_overrides=SMALL_ARCH["chemberta_overrides"],
    crossmodal_overrides={"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0},
)


def _fit_kwargs(train_p, exp):
    # Adam's first moment in fp32: stored in bf16 (the default) a gradient
    # one fp32 ulp apart can round to the next bf16 value, a 0.4 % step
    # difference that drifts the two fits apart by 5e-5 in the FDS means
    return dict(task="regression", epochs=2, learning_rate=1e-3, batch_size=8,
                early_stopping=5, metrics="mse", smiles_col="smiles", save_path=exp,
                target_cols=["measured"], using_infonce=True, using_ct=True, raw_data=train_p,
                use_weight=True, fds=True, fds_num=8, fds_raw_path=train_p,
                fds_col_data="measured", seed=42, compute_dtype="float32", mu_dtype="float32",
                use_pallas=False,
                **NO_DROPOUT)


@contextlib.contextmanager
def jax_parity_patches(random_init_only=False):
    """InfoNCE's query dropout is 0 in both packages, and the port's NNModel
    starts from the parameters the JAX NNModel drew last (its fit must run
    first).  Both packages featurize at their defaults (the native C++
    refinement and distances, each package's own build of one source).
    With ``random_init_only`` only the random draw is shared: each package
    then loads the pretrained checkpoints over it with its own ingestion."""
    mp = pytest.MonkeyPatch()
    # InfoNCE's query dropout (0.1) has no config knob: 0 in both packages
    mp.setattr(jax_mm, "InfoNCE", functools.partial(jax_mm.InfoNCE, embed_dropout=0.0))
    mp.setattr(port_mm, "InfoNCE", functools.partial(port_mm.InfoNCE, embed_dropout=0.0))
    captured = {}
    if random_init_only:
        real_load = jax_nnmodel.load_pretrained

        def jax_load(tree, **dirs):
            # the random draw, copied before the ingestion writes into it
            captured["params"] = flax_params_to_state_dict(tree)
            return real_load(tree, **dirs)

        mp.setattr(jax_nnmodel, "load_pretrained", jax_load)
        mp.setattr(port_nnmodel.NNModel, "_random_init", lambda self: (
            self.model.load_state_dict(captured["params"])))
    else:
        real_init = jax_nnmodel.NNModel._init_params

        def jax_init(self, params):
            captured["params"] = real_init(self, params)
            return captured["params"]

        mp.setattr(jax_nnmodel.NNModel, "_init_params", jax_init)
        mp.setattr(port_nnmodel.NNModel, "_init_params", lambda self, params: (
            self.model.load_state_dict(flax_params_to_state_dict(captured["params"]))))
    try:
        yield
    finally:
        mp.undo()


def split_csvs(tmp, smiles=SMILES_20, n_train=16, seed=0):
    """train.csv (the first n_train SMILES) and val.csv (the rest) under
    tmp, with targets drawn from ``seed``."""
    y = np.random.RandomState(seed).randn(len(smiles)) * 2 + 1
    df = pd.DataFrame({"smiles": smiles, "measured": y})
    train_p, val_p = str(tmp / "train.csv"), str(tmp / "val.csv")
    df.iloc[:n_train].to_csv(train_p, index=False)
    df.iloc[n_train:].to_csv(val_p, index=False)
    return train_p, val_p


@pytest.fixture(scope="module")
def both_fits(tmp_path_factory):
    from mmdti_tpu import MolPredict as JaxPredict
    from mmdti_tpu import MolTrain as JaxTrain
    from mmdti_tpu_torch import MolPredict, MolTrain

    tmp = tmp_path_factory.mktemp("fit")
    train_p, val_p = split_csvs(tmp)
    out = {}
    with jax_parity_patches():
        for name, train_cls, pred_cls, extra in (
                ("jax", JaxTrain, JaxPredict, {}),
                ("port", MolTrain, MolPredict, {"device": "cpu"})):
            exp = str(tmp / f"exp_{name}")
            fit = train_cls(**_fit_kwargs(train_p, exp), **extra).fit(train_p, val_p)
            pred = pred_cls(load_model=exp, **extra).predict(val_p, save_path=str(tmp / name))
            with open(os.path.join(exp, "history_0.json")) as f:
                hist = json.load(f)
            with open(os.path.join(exp, "model_0.ckpt"), "rb") as f:
                saved = flax.serialization.msgpack_restore(f.read())
            out[name] = dict(exp=exp, cv_pred=np.asarray(fit.cv_pred), pred=np.asarray(pred),
                             hist=hist, ckpt=saved, out=str(tmp / name))
    return out


def _best_epoch(hist):
    best, at = float("inf"), None
    for row in hist:
        if row["val_mse"] <= best:
            best, at = row["val_mse"], row["epoch"]
    return at


def test_fit_history_matches_jax(both_fits):
    jx, pt = both_fits["jax"]["hist"], both_fits["port"]["hist"]
    assert len(jx) == len(pt) == 2
    assert _best_epoch(jx) == _best_epoch(pt)
    for a, b in zip(jx, pt):
        for k in ("val_loss", "val_mse", "train_loss", "m_loss", "infonce_loss", "ct_loss"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)


def test_fit_saves_the_fds_state_of_jax(both_fits):
    jx, pt = both_fits["jax"]["ckpt"], both_fits["port"]["ckpt"]
    assert set(pt["fds"]) == set(jx["fds"])
    for k in jx["fds"]:
        np.testing.assert_allclose(pt["fds"][k], jx["fds"][k], atol=1e-5, err_msg=k)
    assert jax.tree_util.tree_structure(pt["params"]) == jax.tree_util.tree_structure(
        jx["params"])


def test_molpredict_matches_jax(both_fits):
    jx, pt = both_fits["jax"], both_fits["port"]
    np.testing.assert_allclose(pt["pred"], jx["pred"], atol=1e-4)
    np.testing.assert_allclose(pt["cv_pred"], jx["cv_pred"], atol=1e-4)
    # the predict artifacts: the same columns, the truth scored
    assert sorted(os.listdir(pt["out"])) == sorted(os.listdir(jx["out"]))
    ours = pd.read_csv(os.path.join(pt["out"], "val.predict.0.csv"))
    theirs = pd.read_csv(os.path.join(jx["out"], "val.predict.0.csv"))
    assert list(ours.columns) == list(theirs.columns)
    np.testing.assert_allclose(ours["predict_measured"], theirs["predict_measured"], atol=1e-4)


def test_jax_package_reads_the_port_experiment(both_fits):
    """The port's config.yaml and model_0.ckpt load in the JAX package."""
    from mmdti_tpu.train.checkpointing import load_checkpoint

    exp = both_fits["port"]["exp"]
    cfg = jax_load_yaml(os.path.join(exp, "config.yaml"))
    assert cfg.task == "regression" and cfg.target_cols == "measured" and cfg.model_folds == 1
    restored = load_checkpoint(exp, 0)
    assert restored["params"]["encoder"]["layers_0"]["in_proj"]["kernel"].shape == (32, 96)


_BLOCKED_HEADER = textwrap.dedent("""
    import os, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "mmdti_tpu", "pandas", "sklearn",
               "joblib", "yaml", "msgpack", "transformers", "tokenizers", "safetensors",
               "regex", "rdkit"}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    from mmdti_tpu_torch import MolPredict, MolTrain
    from mmdti_tpu_torch.data.reader import write_csv
    from mmdti_tpu_torch.finetune import make_synthetic_dataset
    from mmdti_tpu_torch.splits import random_scaffold_split

    work, task = sys.argv[1], sys.argv[2]
    data = os.path.join(work, "synthetic.csv")
    make_synthetic_dataset(data, n=40, seed=0, task=task)
    paths = {}
    for name, table in zip(("train", "val", "test"), random_scaffold_split(data, 0, 0.2, 0.2)):
        paths[name] = os.path.join(work, name + ".csv")
        write_csv(table, paths[name])
    exp = os.path.join(work, "exp")
    small = dict(unimol_overrides=dict(encoder_layers=1, embed_dim=16, ffn_embed_dim=32,
                                       attention_heads=2),
                 chemberta_overrides=dict(hidden_size=16, num_hidden_layers=1,
                                          num_attention_heads=2, intermediate_size=32),
                 crossmodal_overrides=dict(num_attention_heads=2))
""")

_BLOCKED_FIT = _BLOCKED_HEADER + textwrap.dedent("""
    MolTrain(task="regression", epochs=1, batch_size=8, metrics="mse", smiles_col="smiles",
             save_path=exp, target_cols=["measured"], using_infonce=True, using_ct=True,
             use_weight=True, fds=True, fds_num=8, raw_data=paths["train"],
             compute_dtype="float32", device="cpu", **small).fit(paths["train"], paths["val"])
    pred = MolPredict(load_model=exp, device="cpu").predict(paths["test"],
                                                            save_path=os.path.join(work, "out"))
    assert np.isfinite(pred).all() and pred.shape[1] == 1
    assert {"config.yaml", "model_0.ckpt", "target_scaler.ss",
            "history_0.json"} <= set(os.listdir(exp))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("PORT_FIT_OK")
""")

# binary classification: threshold.dat written without joblib and read back,
# the probability and label columns, the AUC scored
_BLOCKED_CLASSIFICATION_FIT = _BLOCKED_HEADER + textwrap.dedent("""
    MolTrain(task="classification", epochs=1, batch_size=8, metrics="auc",
             smiles_col="smiles", save_path=exp, target_cols=["measured"],
             using_infonce=True, using_ct=True, threshold_search=True,
             compute_dtype="float32", device="cpu", **small).fit(paths["train"], paths["val"])
    out = os.path.join(work, "out")
    pred = MolPredict(load_model=exp, device="cpu").predict(paths["test"], save_path=out)
    assert pred.shape[1] == 1 and ((pred >= 0) & (pred <= 1)).all()
    assert {"config.yaml", "model_0.ckpt", "threshold.dat",
            "history_0.json"} <= set(os.listdir(exp))
    with open(os.path.join(out, "test.predict.0.csv")) as f:
        header = f.readline().strip().split(",")
    assert header[-2:] == ["prob_measured", "predict_measured"], header
    assert "test_metric.result" in os.listdir(out)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("PORT_FIT_OK")
""")


def _run_blocked(script, tmp_path, task):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run([sys.executable, "-c", script, str(tmp_path), task], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


def test_fit_path_runs_without_jax_or_host_deps(tmp_path):
    proc = _run_blocked(_BLOCKED_FIT, tmp_path, "regression")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PORT_FIT_OK" in proc.stdout


def test_classification_fit_path_runs_without_jax_or_host_deps(tmp_path):
    proc = _run_blocked(_BLOCKED_CLASSIFICATION_FIT, tmp_path, "classification")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PORT_FIT_OK" in proc.stdout


# the scaler modes' fits run last: this process has compiled the JAX fit by now
def test_power_trans_fit_matches_jax(tmp_path):
    """target_normalize="power_trans" on positive targets (Box-Cox) through
    both packages' fit -> predict (tests/torch_task_parity.py) at the fit
    tolerances; joblib reads the port's scaler as a PowerTransformer."""
    import joblib

    from tests.torch_task_parity import (
        assert_history_equal,
        assert_predictions_equal,
        both_fits,
        one_thread,
    )

    threads = one_thread()
    try:
        y = np.abs(np.random.RandomState(4).randn(20)) * 2 + 0.3
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # scikit-learn's version warning
            fits = both_fits(tmp_path, "regression", {"y": y}, "mse",
                             target_normalize="power_trans")
            scaler = joblib.load(os.path.join(fits["port"]["exp"], "target_scaler.ss"))
    finally:
        torch.set_num_threads(threads)
    assert_history_equal(fits, "mse")
    assert_predictions_equal(fits)
    assert type(scaler).__name__ == "PowerTransformer" and scaler.method == "box-cox"


def test_normalizer_fails_the_fit_in_both_packages(tmp_path):
    """scikit-learn's Normalizer has no inverse_transform: the JAX fit fails
    at its first validation with an AttributeError, the port's at the same
    point with a ValueError that says why; both wrote the Normalizer."""
    import joblib

    from mmdti_tpu import MolTrain as JaxTrain
    from mmdti_tpu_torch import MolTrain
    from tests.torch_task_parity import fit_kwargs, one_thread, task_csvs

    threads = one_thread()
    try:
        y = np.random.RandomState(3).randn(20) * 2 + 1
        train_p, val_p = task_csvs(tmp_path, {"y": y})
        kw = dict(fit_kwargs("regression", ["y"], "mse", ""), epochs=1,
                  target_normalize="normalizer")
        with pytest.raises(AttributeError, match="inverse_transform"):
            JaxTrain(**dict(kw, save_path=str(tmp_path / "jax"))).fit(train_p, val_p)
        with pytest.raises(ValueError, match="normalizer.*no inverse_transform"):
            MolTrain(**dict(kw, save_path=str(tmp_path / "port")), device="cpu").fit(train_p,
                                                                                     val_p)
    finally:
        torch.set_num_threads(threads)
    for d in ("jax", "port"):
        assert type(joblib.load(str(tmp_path / d / "target_scaler.ss"))).__name__ == "Normalizer"
