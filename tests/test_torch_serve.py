"""mmdti_tpu_torch serving slice on the CPU: host featurization equals the
JAX package's, MolServe.predict equals the flax model on the same weights
(atol 1e-4, fp32), and the port (serving from memory and from an
experiment dir, one HTTP round trip, one train step, a k-fold CV fit and
its ensemble predict, a stopped and resumed fit, the native chemistry, the
device conformer provider and the prefetched feed) imports nothing of JAX
or the JAX package's host dependencies."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdti_tpu.chem.conformer import ConformerGen as JaxConformerGen
from mmdti_tpu.chem.tokenizer import SmilesTokenizer as JaxTokenizer
from mmdti_tpu.data.batching import BatchCollator as JaxCollator
from mmdti_tpu.models.mm_model import build_model as jax_build_model
from mmdti_tpu_torch.api.serve_api import MolServe
from mmdti_tpu_torch.chem.conformer import ConformerGen
from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
from mmdti_tpu_torch.data.batching import BatchCollator
from mmdti_tpu_torch.models.convert import flax_params_to_state_dict
from tests.conftest import SMALL_ARCH, SMILES_20

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(
    task="classification", compute_dtype="float32",
    unimol_overrides=SMALL_ARCH["unimol_overrides"],
    chemberta_overrides=SMALL_ARCH["chemberta_overrides"],
)


def _jax_batch(smiles):
    gen = JaxConformerGen(coord_provider="host")
    feats = gen.transform(smiles)
    for f, s in zip(feats, smiles):
        f["smile"] = s
    coll = JaxCollator(JaxTokenizer(), pad_idx=gen.dictionary.pad(), pad_mode="bucket")
    batch, _ = coll([(f, np.zeros(1, np.float32)) for f in feats])
    return gen, feats, batch


def test_host_featurization_equals_jax():
    _, jax_feats, jax_batch = _jax_batch(SMILES_20)
    gen = ConformerGen()
    feats = gen.transform(SMILES_20)
    for a, b in zip(feats, jax_feats):
        assert set(a) == set(b) - {"smile"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for f, s in zip(feats, SMILES_20):
        f["smile"] = s
    coll = BatchCollator(SmilesTokenizer(), pad_idx=gen.dictionary.pad(), pad_mode="bucket")
    batch, _ = coll([(f, np.zeros(1, np.float32)) for f in feats])
    assert set(batch) == {"src_tokens", "src_distance", "src_edge_type",
                          "input_ids", "attention_mask"}
    for k in batch:
        assert batch[k].dtype == jax_batch[k].dtype, k
        np.testing.assert_array_equal(batch[k], jax_batch[k], err_msg=k)


def test_predict_matches_flax_on_same_weights():
    smiles = SMILES_20[:6]
    gen, _, batch = _jax_batch(smiles)
    model = jax_build_model(
        output_dim=2, atom_vocab_size=len(gen.dictionary), atom_pad_idx=gen.dictionary.pad(),
        task="classification", smiles_vocab_size=JaxTokenizer().vocab_size,
        compute_dtype="float32", use_pallas=False,
        unimol_overrides=SMALL_ARCH["unimol_overrides"],
        chemberta_overrides=SMALL_ARCH["chemberta_overrides"],
    )
    feats = {k: jnp.asarray(batch[k]) for k in
             ("src_tokens", "src_distance", "src_edge_type", "input_ids", "attention_mask")}
    params = jax.jit(model.init)(jax.random.PRNGKey(3), **feats)["params"]
    want = np.asarray(jax.nn.softmax(
        jax.jit(model.apply)({"params": params}, **feats)["logits"], axis=-1
    )[:, 1:])

    server = MolServe.from_state_dict(
        CONFIG, flax_params_to_state_dict(jax.tree.map(np.asarray, params)),
        device="cpu", batch_buckets=(8,))
    out = server.predict(smiles)
    np.testing.assert_allclose(out["proba"], want, atol=1e-4)
    assert out["predict"].shape == (6, 1) and out["valid"].all()
    assert server.latency_stats()["count"] == 1
    # a repeated request is answered from the featurization cache, unchanged
    again = server.predict(smiles)
    assert server.cache_hits == len(smiles)
    np.testing.assert_array_equal(again["proba"], out["proba"])
    shapes = server.compiled_shapes
    server.warmup_buckets(batch_sizes=(2,), atom_buckets=(32,), smiles_buckets=(48,))
    assert server.compiled_shapes == shapes + 1


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MolServe.from_state_dict(CONFIG, {}, device="cuda")


_BLOCKED_SCRIPT = textwrap.dedent("""
    import sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "mmdti_tpu", "pandas", "sklearn",
               "joblib", "yaml", "msgpack", "transformers", "tokenizers", "safetensors",
               "regex", "rdkit", "pymatgen"}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    # torch.utils.checkpoint (encoder remat) imports torch._dynamo, which
    # asks importlib whether pandas and other packages exist; the block
    # would answer with an error where a machine without them answers None
    import torch._dynamo

    sys.meta_path.insert(0, Block())

    import numpy as np
    import torch
    from mmdti_tpu_torch import MolServe
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.models.mm_model import build_model

    cfg = dict(task="regression", compute_dtype="float32",
               unimol_overrides=dict(encoder_layers=1, embed_dim=16, ffn_embed_dim=32,
                                     attention_heads=2),
               chemberta_overrides=dict(hidden_size=16, num_hidden_layers=1,
                                        num_attention_heads=2, intermediate_size=32),
               crossmodal_overrides=dict(num_attention_heads=2))
    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    model = build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                        unimol_overrides=cfg["unimol_overrides"],
                        chemberta_overrides=cfg["chemberta_overrides"],
                        crossmodal_overrides=cfg["crossmodal_overrides"])
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    server = MolServe.from_state_dict(cfg, model.state_dict(), device="cpu")
    out = server.predict(["CCO", "c1ccccc1"])
    assert out["predict"].shape == (2, 1) and np.isfinite(out["predict"]).all()
    device_mode = MolServe.from_state_dict(cfg, model.state_dict(), device="cpu",
                                           device_pair_feats="device")
    np.testing.assert_allclose(device_mode.predict(["CCO", "c1ccccc1"])["predict"],
                               out["predict"], atol=1e-5)

    # the MOF path: pair features from coordinates, the MOF reader, a MOF model
    from mmdti_tpu_torch.chem.mof import GAS2ATTR, MOFReader, coords2unimol_mof
    from mmdti_tpu_torch.models.mof import build_mof_model
    from mmdti_tpu_torch.ops.pair_feats import mof_pair_feats_from_coords

    reader = MOFReader()
    feat = coords2unimol_mof(["Zn", "O", "C"], np.eye(3, dtype=np.float32), reader.dictionary)
    mof = build_mof_model(1, len(reader.dictionary), reader.dictionary.pad(), "regression",
                          unimol_overrides=cfg["unimol_overrides"])
    mof.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(feat["src_tokens"])[None]
    coord = torch.from_numpy(feat["src_coord"])[None]
    dist, _ = mof_pair_feats_from_coords(tok, coord, len(reader.dictionary),
                                         reader.dictionary.pad())
    np.testing.assert_allclose(dist[0].numpy(), feat["src_distance"], atol=1e-5)
    mof_out = mof(tok, src_coord=coord, gas_id=torch.tensor([2]),
                  gas_attr=torch.tensor([GAS2ATTR["CO2"]]), pressure=torch.tensor([0.5]),
                  temperature=torch.tensor([0.3]))
    assert mof_out["logits"].shape == (1, 1) and torch.isfinite(mof_out["logits"]).all()

    # an experiment dir written with the port's writers, served from disk,
    # and one round trip through the HTTP front
    import json, os, threading, urllib.request
    from mmdti_tpu_torch.configs.config import default_config, save_yaml
    from mmdti_tpu_torch.models.convert import state_dict_to_flax_params
    from mmdti_tpu_torch.train.checkpointing import save_checkpoint

    exp = sys.argv[1]
    save_yaml({**default_config(), **cfg, "target_cols": "y", "use_scaler": False,
               "model_folds": 1}, os.path.join(exp, "config.yaml"))
    save_checkpoint(exp, 0, state_dict_to_flax_params(model.state_dict()))
    served = MolServe(exp, device="cpu")
    np.testing.assert_allclose(served.predict(["CCO", "c1ccccc1"])["predict"],
                               out["predict"], rtol=1e-6)
    srv = served.make_server(port=0, dynamic_batch_window_ms=2.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    req = urllib.request.Request(f"http://127.0.0.1:{srv.server_port}/predict",
                                 data=json.dumps({"smiles": ["CCO"]}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
    srv.shutdown()
    srv.server_close()
    np.testing.assert_allclose(body["predict"], served.predict(["CCO"])["predict"], rtol=1e-6)

    # one train step, dropout on, on the served model's weights
    from mmdti_tpu_torch.losses.zoo import mse_loss
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import build_train_step

    feats = server._place_feats(server._collate(server._featurize(["CCO", "c1ccccc1"]))[0])
    opt = FusedAdam(dict(server.model.named_parameters()), 1e-4, 10)
    step = build_train_step(server.model, opt, mse_loss, "regression")
    labels = torch.zeros(feats["src_tokens"].shape[0], 1)
    metrics = step(feats, labels, None, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values()), metrics

    # k-fold cross-validation (scaffold folds, the scaler written as
    # joblib writes scikit-learn's), then a fit stopped after epoch 1 and
    # resumed from its train state
    from mmdti_tpu_torch import MolPredict, MolTrain
    from mmdti_tpu_torch.data.reader import read_csv, take_rows, write_csv
    from mmdti_tpu_torch.finetune import make_synthetic_dataset

    data = os.path.join(exp, "synthetic.csv")
    make_synthetic_dataset(data, n=32, seed=0)
    fit = dict(task="regression", batch_size=8, metrics="mse", smiles_col="smiles",
               target_cols=["measured"], compute_dtype="float32", device="cpu",
               **{k: v for k, v in cfg.items() if k.endswith("_overrides")})
    cv = MolTrain(epochs=1, kfold=2, split="scaffold", save_path=os.path.join(exp, "cv"),
                  **fit).fit(data)
    assert cv.cv_pred.shape == (len(cv.data_train["target"]), 1)
    assert np.isfinite(cv.cv_pred).all()
    ens = MolPredict(load_model=os.path.join(exp, "cv"), device="cpu").predict(data)
    assert ens.shape == (32, 1) and np.isfinite(ens).all()
    table = read_csv(data)
    halves = {}
    for name, rows in (("train", list(range(24))), ("val", list(range(24, 32)))):
        halves[name] = os.path.join(exp, name + ".csv")
        write_csv(take_rows(table, rows), halves[name])
    resumed = os.path.join(exp, "resumed")
    MolTrain(epochs=2, stop_after_epoch=1, save_path=resumed, **fit).fit(halves["train"],
                                                                          halves["val"])
    assert os.path.exists(os.path.join(resumed, "train_state_0.ckpt"))
    MolTrain(epochs=2, resume=True, save_path=resumed, **fit).fit(halves["train"],
                                                                  halves["val"])
    with open(os.path.join(resumed, "history_0.json")) as f:
        assert [r["epoch"] for r in json.load(f)] == [1, 2]

    # pretrained fine-tuning: a unicore checkpoint (the dictionary beside
    # it) and a ChemBERTa dir (bf16 safetensors, the BPE fixture), the
    # encoder's lower layer and ChemBERTa frozen; predict and serve the dir
    import shutil
    import chip_smoke
    from mmdti_tpu_torch.chem.tokenizer import RobertaBPETokenizer
    from mmdti_tpu_torch.models.hf_weights import read_hf_state_dict, read_unicore_checkpoint
    from mmdti_tpu_torch.train.checkpointing import load_checkpoint
    from mmdti_tpu_torch.models.convert import flax_params_to_state_dict

    os.makedirs(os.path.join(exp, "unimol"))
    shutil.copy(os.path.join(chip_smoke.REPO, "mmdti_tpu_torch", "chem", "mol.dict.txt"),
                os.path.join(exp, "unimol"))
    unimol = os.path.join(exp, "unimol", "unimol.pt")
    chip_smoke.write_unicore_checkpoint(unimol, 0, vocab=len(d), embed_dim=16, layers=1,
                                        heads=2, ffn=32)
    cb = os.path.join(exp, "chemberta")
    chip_smoke.write_chemberta_dir(cb, 1, hidden=16, layers=1, heads=2, intermediate=32,
                                   max_positions=130)
    assert sorted(read_unicore_checkpoint(unimol)) == ["args", "extra_state", "model",
                                                       "optimizer_history"]
    pre = os.path.join(exp, "pretrained")
    MolTrain(epochs=1, save_path=pre, unimol_dir=unimol, chemberta_dir=cb,
             freeze_layers="embed_tokens.,gbf.", freeze_module="bert",
             **fit).fit(halves["train"], halves["val"])
    saved = flax_params_to_state_dict(load_checkpoint(pre, 0)["params"])
    files = read_hf_state_dict(cb)
    assert torch.equal(saved["bert.layer_0.output.weight"],
                       files["roberta.encoder.layer.0.output.dense.weight"])
    pred = MolPredict(load_model=pre, device="cpu").predict(halves["val"])
    pre_server = MolServe(pre, device="cpu")
    assert isinstance(pre_server.tokenizer, RobertaBPETokenizer)
    served = pre_server.predict(list(read_csv(halves["val"])["smiles"]))["predict"]
    np.testing.assert_allclose(np.asarray(served).reshape(pred.shape), pred, atol=1e-5)
    # conformers: the native library built from the port's own source, the
    # device provider (on the CPU here) and the prefetched host feed
    from mmdti_tpu_torch.chem import native
    from mmdti_tpu_torch.chem.conformer import ConformerGen
    from mmdti_tpu_torch.data.pipeline import StreamPut, prefetch_to_device
    from mmdti_tpu_torch.ops._build import BUILD_DIR

    assert native.available() and native._lib()._name.startswith(BUILD_DIR)
    confs = ConformerGen(coord_provider="device", device="cpu",
                         device_refine_min_atoms=0).transform(["CCO", "C" * 20])
    assert all(np.isfinite(f["src_coord"]).all() for f in confs)
    fed = [s.take() for s in prefetch_to_device([(np.ones(2), None)], StreamPut("cpu"))]
    assert fed[0][0].sum().item() == 2 and fed[0][1] is None
    # every target_normalize mode fitted, written as joblib's pickle and
    # read back; a fit step with encoder remat
    from mmdti_tpu_torch.data.scaler import SCALER_MODE, TargetScaler

    y = np.abs(np.random.RandomState(0).randn(30, 2)) + 0.1
    for mode in SCALER_MODE:
        fitted = TargetScaler(mode, "multilabel_regression")
        fitted.fit(y, os.path.join(exp, "scaler_" + mode))
        again = TargetScaler(mode, "multilabel_regression", os.path.join(exp, "scaler_" + mode))
        np.testing.assert_array_equal(again.transform(y), fitted.transform(y))
    remat = build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                        unimol_overrides=dict(cfg["unimol_overrides"], remat=True),
                        chemberta_overrides=cfg["chemberta_overrides"],
                        crossmodal_overrides=cfg["crossmodal_overrides"])
    remat.load_state_dict(model.state_dict())
    step = build_train_step(remat, FusedAdam(dict(remat.named_parameters()), 1e-4, 10),
                            mse_loss, "regression")
    assert torch.isfinite(step(feats, labels, None, torch.Generator().manual_seed(0))["loss"])
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("PORT_ONLY_OK")
""")


def test_slice_runs_without_jax_or_host_deps(tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SCRIPT, str(tmp_path)], cwd=REPO,
                          env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PORT_ONLY_OK" in proc.stdout
