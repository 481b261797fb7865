"""Pretrained-checkpoint fine-tuning in mmdti_tpu_torch on the CPU against
the JAX package.

* Uni-Mol ingestion: ``convert_unimol_checkpoint`` and ``load_pretrained``
  of both packages on one synthetic unicore ``.pt`` (the ``model`` key,
  ``unimat.`` names, ``args``, pretraining heads, a layer more than the
  model has and two shape-mismatched tensors): the port's state dict
  equals ``flax_params_to_state_dict`` of the JAX result exactly, with the
  same loaded, missing and mismatched counts; a file of which nothing
  lands raises in both.
* ChemBERTa ingestion: a tiny seeded ``RobertaForMaskedLM`` saved by
  ``transformers`` as fp32 safetensors, bf16 safetensors, a
  ``pytorch_model.bin`` and sharded safetensors; the port's
  ``load_pretrained`` (no transformers) equals the JAX one (through
  ``AutoModel``) exactly, and so do ``hf_chemberta_overrides``; a dir with
  config.json and no weights raises in the port.
* The frozen set: ``frozen_parameter_names`` against the True leaves of
  the JAX package's ``_build_frozen_mask``, mapped by the bridge rule.
* The slice: ``MolTrain.fit`` -> ``MolPredict`` with ``unimol_dir``,
  ``chemberta_dir``, ``freeze_layers`` and ``freeze_module`` in both
  packages from the same random draw (tests/torch_task_parity.py):
  predictions 1e-5 abs / 1e-4 rel, history 1e-5, the frozen tensors of
  model_0.ckpt bit-equal to the files' in both, each package predicting
  the other's dir; and a resume with freezing on bit-equal to the
  uninterrupted fit, a resume with another freeze refused.
"""

import contextlib
import json
import logging
import os
import re
import shutil
import types

os.environ.setdefault("USE_TF", "0")   # transformers would import TensorFlow otherwise

import numpy as np
import pytest
import torch
import transformers

import chip_smoke
import mmdti_tpu.models.convert as jax_convert
import mmdti_tpu.train.nnmodel as jax_nnmodel
from mmdti_tpu.api.serve_model import chemberta_overrides as jax_chemberta_overrides
from mmdti_tpu_torch.chem.dictionary import Dictionary
from mmdti_tpu_torch.models import convert
from mmdti_tpu_torch.models.convert import flax_params_to_state_dict, state_dict_to_flax_params
from mmdti_tpu_torch.models.mm_model import build_model
from mmdti_tpu_torch.train.nnmodel import frozen_parameter_names
from tests.conftest import SMALL_ARCH
from tests.torch_task_parity import (
    PRED_ATOL,
    PRED_RTOL,
    assert_history_equal,
    assert_jax_predicts_port_experiment,
    assert_predictions_equal,
    both_fits,
    one_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIMOL = SMALL_ARCH["unimol_overrides"]
CHEMBERTA = SMALL_ARCH["chemberta_overrides"]
MAX_POSITIONS = 130
FREEZE_LAYERS = "embed_tokens.,gbf.,gbf_proj.,encoder.emb_layer_norm.,encoder.layers_0."
FREEZE_MODULE = "bert"
HF_FORMS = ("safetensors", "safetensors_bf16", "bin", "sharded")


def _dictionary():
    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    return d


def _port_model(**unimol):
    d = _dictionary()
    with open(os.path.join(chip_smoke.BPE_FIXTURE, "vocab.json")) as f:
        vocab = len(json.load(f))
    return build_model(1, len(d), d.pad(), vocab, unimol_overrides={**UNIMOL, **unimol},
                       chemberta_overrides={**CHEMBERTA,
                                            "max_position_embeddings": MAX_POSITIONS})


def _state(seed=0, **unimol):
    model = _port_model(**unimol).reset_parameters_like_flax(torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def jax_log():
    """The JAX package's log lines (its logger does not propagate)."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    lg = logging.getLogger("MMDTI-TPU")
    handler = Keep()
    lg.addHandler(handler)
    try:
        yield lines
    finally:
        lg.removeHandler(handler)


def _counts(lines, what):
    """(loaded, missing, mismatched) from a JAX converter's log line."""
    for line in lines:
        m = re.match(rf"{what} checkpoint: (\d+) tensors loaded, (\d+) missing, "
                     r"(\d+) shape-mismatched", line)
        if m:
            return tuple(int(g) for g in m.groups())
    raise AssertionError(f"no {what} counts in {lines}")


def _port_counts(stats):
    return stats["loaded"], len(stats["missing"]), len(stats["shape"])


def _assert_state_equal(port, jax_tree):
    want = flax_params_to_state_dict(jax_tree)
    assert set(port) == set(want)
    for k, v in want.items():
        assert torch.equal(port[k], v), k


# ---- Uni-Mol ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def unicore_file(tmp_path_factory):
    """A unicore checkpoint for SMALL_ARCH's encoder with one layer more
    than the model and a classification head of another width."""
    path = str(tmp_path_factory.mktemp("unicore") / "unimol.pt")
    chip_smoke.write_unicore_checkpoint(path, 3, vocab=len(_dictionary()),
                                        embed_dim=UNIMOL["embed_dim"],
                                        layers=UNIMOL["encoder_layers"] + 1,
                                        heads=UNIMOL["attention_heads"],
                                        ffn=UNIMOL["ffn_embed_dim"])
    ckpt = torch.load(path, weights_only=False)
    rng = np.random.RandomState(4)
    E = UNIMOL["embed_dim"]
    ckpt["model"]["unimat.classification_head.dense.weight"] = torch.from_numpy(
        rng.randn(E, E).astype(np.float32))
    ckpt["model"]["unimat.classification_head.out_proj.weight"] = torch.from_numpy(
        rng.randn(3, E).astype(np.float32))
    ckpt["model"]["unimat.classification_head.out_proj.bias"] = torch.from_numpy(
        rng.randn(3).astype(np.float32))
    torch.save(ckpt, path)
    return path


def test_unimol_converter_equals_jax(unicore_file):
    ckpt = torch.load(unicore_file, weights_only=False)
    sd = _state()
    tree = state_dict_to_flax_params(sd)
    stats = {}
    with jax_log() as lines:
        jax_tree = jax_convert.convert_unimol_checkpoint(ckpt, tree)
    port = convert.convert_unimol_checkpoint(ckpt, dict(sd), stats=stats)
    _assert_state_equal(port, jax_tree)
    # embed_tokens, gbf (4), gbf_proj (4), the encoder's two LayerNorms (4),
    # 2 layers (24) and the head's dense weight land; layer 2 (12 tensors)
    # is missing; the head's out_proj (2 tensors) mismatches
    assert _port_counts(stats) == _counts(lines, "Uni-Mol") == (38, 12, 2)
    assert not torch.equal(port["encoder.layers_1.fc1.weight"], sd["encoder.layers_1.fc1.weight"])
    # unicore [out, in] lands untransposed, gbf's [1, K] tables flat
    np.testing.assert_array_equal(port["encoder.layers_0.fc1.weight"].numpy(),
                                  ckpt["model"]["unimat.encoder.layers.0.fc1.weight"].numpy())
    assert port["gbf.means"].shape == (128,)


def test_unimol_load_pretrained_reads_the_file_as_jax(unicore_file):
    sd = _state()
    stats = {}
    with jax_log() as lines:
        jax_tree = jax_convert.load_pretrained(state_dict_to_flax_params(sd),
                                               unimol_dir=unicore_file)
    port = convert.load_pretrained(dict(sd), unimol_dir=unicore_file, stats=stats)
    _assert_state_equal(port, jax_tree)
    assert _port_counts(stats["unimol"]) == _counts(lines, "Uni-Mol")


def test_unimol_checkpoint_landing_nothing_raises_in_both():
    ckpt = {"model": {"unimat.lm_head.dense.weight": torch.zeros(4, 4),
                      "unimat.encoder.layers.0.fc1.weight": torch.zeros(7, 5)}}
    sd = _state()
    with pytest.raises(ValueError, match="loaded 0 tensors"):
        jax_convert.convert_unimol_checkpoint(ckpt, state_dict_to_flax_params(sd))
    with pytest.raises(ValueError, match="loaded 0 tensors"):
        convert.convert_unimol_checkpoint(ckpt, dict(sd))


def test_unicore_file_naming_another_class_is_not_unpickled(tmp_path):
    path = str(tmp_path / "evil.pt")
    torch.save({"model": {}, "extra_state": types.SimpleNamespace(x=1)}, path)
    with pytest.raises(Exception, match="SimpleNamespace"):
        convert.load_pretrained(_state(), unimol_dir=path)


# ---- ChemBERTa --------------------------------------------------------------------

def _roberta_config(vocab):
    return transformers.RobertaConfig(
        vocab_size=vocab, hidden_size=CHEMBERTA["hidden_size"],
        num_hidden_layers=CHEMBERTA["num_hidden_layers"],
        num_attention_heads=CHEMBERTA["num_attention_heads"],
        intermediate_size=CHEMBERTA["intermediate_size"],
        max_position_embeddings=MAX_POSITIONS, type_vocab_size=1, pad_token_id=1)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """One seeded tiny RobertaForMaskedLM saved the four ways, each dir with
    the BPE fixture's tokenizer files."""
    with open(os.path.join(chip_smoke.BPE_FIXTURE, "vocab.json")) as f:
        vocab = len(json.load(f))
    torch.manual_seed(0)
    model = transformers.RobertaForMaskedLM(_roberta_config(vocab))
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.05) + p)
    root = tmp_path_factory.mktemp("hf")
    dirs = {}
    for form in HF_FORMS:
        d = dirs[form] = str(root / form)
        if form == "safetensors":
            model.save_pretrained(d)
        elif form == "safetensors_bf16":
            model.to(torch.bfloat16).save_pretrained(d)
            model.to(torch.float32)
        elif form == "bin":
            model.save_pretrained(d, safe_serialization=False)
        else:
            model.save_pretrained(d, max_shard_size="40KB")
        for name in chip_smoke.BPE_FILES:
            shutil.copy(os.path.join(chip_smoke.BPE_FIXTURE, name), d)
    return dirs


def test_hf_forms_hold_the_expected_files(hf_dirs):
    assert os.listdir(hf_dirs["bin"]).count("pytorch_model.bin") == 1
    assert "model.safetensors.index.json" in os.listdir(hf_dirs["sharded"])
    assert "model.safetensors" not in os.listdir(hf_dirs["sharded"])


@pytest.mark.parametrize("form", HF_FORMS)
def test_chemberta_ingestion_equals_jax(hf_dirs, form):
    sd = _state()
    stats = {}
    with jax_log() as lines:
        jax_tree = jax_convert.load_pretrained(state_dict_to_flax_params(sd),
                                               chemberta_dir=hf_dirs[form])
    port = convert.load_pretrained(dict(sd), chemberta_dir=hf_dirs[form], stats=stats)
    _assert_state_equal(port, jax_tree)
    n_layer = 16 * CHEMBERTA["num_hidden_layers"]
    assert _port_counts(stats["chemberta"]) == _counts(lines, "ChemBERTa") == (5 + n_layer, 0, 0)
    assert not torch.equal(port["bert.layer_0.attn_query.weight"],
                           sd["bert.layer_0.attn_query.weight"])


def test_bf16_weights_widen_exactly(hf_dirs):
    from safetensors.torch import load_file

    port = convert.load_pretrained(_state(), chemberta_dir=hf_dirs["safetensors_bf16"])
    raw = load_file(os.path.join(hf_dirs["safetensors_bf16"], "model.safetensors"))
    w = raw["roberta.encoder.layer.0.intermediate.dense.weight"]
    assert w.dtype == torch.bfloat16
    assert torch.equal(port["bert.layer_0.intermediate.weight"], w.float())


def test_chemberta_overrides_equal_jax(hf_dirs):
    d = hf_dirs["safetensors"]
    assert convert.hf_chemberta_overrides(d) == jax_convert.hf_chemberta_overrides(d)
    cfg = {"chemberta_dir": d, "chemberta_overrides": {"hidden_dropout_prob": 0.0}}
    assert convert.chemberta_overrides(cfg) == jax_chemberta_overrides(cfg)
    assert convert.chemberta_overrides(cfg)["vocab_size"] == 308


def test_chemberta_checkpoint_landing_nothing_raises_in_both():
    src = {"roberta.embeddings.word_embeddings.weight": torch.zeros(5, 7)}
    sd = _state()
    with pytest.raises(ValueError, match="loaded 0 tensors"):
        jax_convert.convert_hf_roberta(src, state_dict_to_flax_params(sd)["bert"])
    with pytest.raises(ValueError, match="loaded 0 tensors"):
        convert.convert_hf_roberta(src, dict(sd))


def test_dir_without_weights_raises(hf_dirs, tmp_path):
    shutil.copy(os.path.join(hf_dirs["safetensors"], "config.json"), tmp_path)
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        convert.load_pretrained(_state(), chemberta_dir=str(tmp_path))


def test_legacy_layer_norm_names_are_renamed(tmp_path):
    from mmdti_tpu_torch.models.hf_weights import read_hf_state_dict

    torch.save({"roberta.embeddings.LayerNorm.gamma": torch.ones(3),
                "roberta.embeddings.LayerNorm.beta": torch.zeros(3)},
               str(tmp_path / "pytorch_model.bin"))
    assert sorted(read_hf_state_dict(str(tmp_path))) == [
        "roberta.embeddings.LayerNorm.bias", "roberta.embeddings.LayerNorm.weight"]


# ---- the frozen set ---------------------------------------------------------------

FREEZE_CASES = {
    "prefix_list": dict(freeze_layers=["encoder.layers_0.", "gbf.", "infonce."]),
    "comma_string": dict(freeze_layers="embed_tokens., encoder.emb_layer_norm.,bert.embeddings."),
    "leaf_prefixes": dict(freeze_layers=["encoder.layers_1.fc1.kernel",
                                         "bert.embeddings.word_embeddings.embedding",
                                         "encoder.layers_0.self_attn_layer_norm.ln.scale"]),
    "reversed": dict(freeze_layers=["classification_head.", "cross_modal_module."],
                     reversed_sel=True),
    "module": dict(freeze_module="bert"),
    "module_list_and_prefix": dict(freeze_module=["bert", "cross_modal_module"],
                                   freeze_layers="gbf_proj."),
    "no_trailing_dot": dict(freeze_layers="encoder.layers_1"),
    "nothing": dict(),
}


@pytest.mark.parametrize("case", sorted(FREEZE_CASES))
def test_frozen_set_equals_jax_mask(case):
    kw = FREEZE_CASES[case]
    model = _port_model(encoder_layers=12)
    tree = state_dict_to_flax_params(model.state_dict())
    mask = jax_nnmodel.NNModel._build_frozen_mask(
        types.SimpleNamespace(params=tree), kw.get("freeze_layers"),
        kw.get("reversed_sel", False), kw.get("freeze_module"))
    want = set() if mask is None else {
        k for k, v in flax_params_to_state_dict(mask).items() if bool(v)}
    got = frozen_parameter_names(model, kw.get("freeze_layers"), kw.get("reversed_sel", False),
                                 kw.get("freeze_module"))
    assert got == want
    if case == "no_trailing_dot":
        # a plain prefix match: layers_1 and layers_10, layers_11
        assert {k.split(".")[1] for k in got} == {"layers_1", "layers_10", "layers_11"}
    if case == "leaf_prefixes":
        assert got == {"encoder.layers_1.fc1.weight", "bert.embeddings.word_embeddings.weight",
                       "encoder.layers_0.self_attn_layer_norm.ln.weight"}


# ---- the slice: fit -> predict, both packages -------------------------------------

@pytest.fixture(scope="module")
def pretrained_dirs(tmp_path_factory, hf_dirs):
    """unimol_dir (a unicore file with SMALL_ARCH's encoder and the
    dictionary beside it) and chemberta_dir (the fp32 safetensors form)."""
    root = tmp_path_factory.mktemp("pretrained")
    os.makedirs(root / "unimol")
    shutil.copy(os.path.join(REPO, "mmdti_tpu_torch", "chem", "mol.dict.txt"), root / "unimol")
    unimol = str(root / "unimol" / "unimol.pt")
    chip_smoke.write_unicore_checkpoint(unimol, 7, vocab=len(_dictionary()),
                                        embed_dim=UNIMOL["embed_dim"],
                                        layers=UNIMOL["encoder_layers"],
                                        heads=UNIMOL["attention_heads"],
                                        ffn=UNIMOL["ffn_embed_dim"])
    return {"unimol_dir": unimol, "chemberta_dir": hf_dirs["safetensors"]}


def _pretrained_tensors(dirs):
    """port name -> the tensor the files hold for it."""
    from mmdti_tpu_torch.models.hf_weights import read_hf_state_dict

    out = {}
    for k, v in torch.load(dirs["unimol_dir"], weights_only=False)["model"].items():
        name = chip_smoke.unicore_port_name(k[len("unimat."):])
        if name is not None:
            out[name] = v.reshape(-1) if name in ("gbf.means", "gbf.stds") else v
    for k, v in read_hf_state_dict(dirs["chemberta_dir"]).items():
        name = chip_smoke.roberta_port_name(k)
        if name is not None:
            out[name] = v
    return out


@pytest.fixture(scope="module")
def fits(tmp_path_factory, pretrained_dirs):
    threads = one_thread()
    try:
        y = np.random.RandomState(0).randn(20) * 2 + 1
        return both_fits(tmp_path_factory.mktemp("fit"), "regression", {"measured": y}, "mse",
                         random_init_only=True, freeze_layers=FREEZE_LAYERS,
                         freeze_module=FREEZE_MODULE, **pretrained_dirs)
    finally:
        torch.set_num_threads(threads)


def test_pretrained_frozen_fit_matches_jax(fits):
    assert_predictions_equal(fits)
    assert_history_equal(fits, "mse")


def test_frozen_tensors_stay_the_files_in_both_packages(fits, pretrained_dirs):
    from mmdti_tpu_torch.train.checkpointing import load_checkpoint

    files = _pretrained_tensors(pretrained_dirs)
    model = _port_model()
    frozen = frozen_parameter_names(model, FREEZE_LAYERS, False, FREEZE_MODULE)
    assert "encoder.layers_0.fc1.weight" in frozen and "bert.layer_0.output.weight" in frozen
    assert frozen <= set(files)
    for pkg in ("jax", "port"):
        saved = flax_params_to_state_dict(load_checkpoint(fits[pkg]["exp"], 0)["params"])
        for name, want in files.items():
            assert torch.equal(saved[name], want) == (name in frozen), (pkg, name)


def test_jax_predicts_the_port_pretrained_dir(fits, tmp_path):
    assert_jax_predicts_port_experiment(fits, tmp_path)


def test_port_predicts_and_serves_the_jax_pretrained_dir(fits, tmp_path):
    from mmdti_tpu_torch import MolPredict, MolServe
    from mmdti_tpu_torch.chem.tokenizer import RobertaBPETokenizer
    from mmdti_tpu_torch.data.reader import read_csv

    threads = one_thread()
    try:
        exp = fits["jax"]["exp"]
        pred = MolPredict(load_model=exp, device="cpu").predict(fits["val"],
                                                                save_path=str(tmp_path))
        np.testing.assert_allclose(pred, fits["jax"]["pred"], atol=PRED_ATOL, rtol=PRED_RTOL)
        server = MolServe(exp, device="cpu")
        assert isinstance(server.tokenizer, RobertaBPETokenizer)
        served = server.predict(list(read_csv(fits["val"])["smiles"]))["predict"]
        np.testing.assert_allclose(np.asarray(served).reshape(pred.shape), fits["jax"]["pred"],
                                   atol=PRED_ATOL, rtol=PRED_RTOL)
    finally:
        torch.set_num_threads(threads)


# ---- resume with freezing ---------------------------------------------------------

def _resume_kwargs(save_path, dirs, **extra):
    from tests.torch_task_parity import fit_kwargs

    return {**fit_kwargs("regression", ["measured"], "mse", save_path, **dirs,
                         freeze_module=FREEZE_MODULE), "device": "cpu", "epochs": 3,
            "freeze_layers": FREEZE_LAYERS, **extra}


@pytest.fixture(scope="module")
def resume_csvs(tmp_path_factory):
    from tests.torch_task_parity import task_csvs

    y = np.random.RandomState(1).randn(20)
    return task_csvs(tmp_path_factory.mktemp("resume_data"), {"measured": y})


def test_resume_with_freezing_is_bit_equal(tmp_path, pretrained_dirs, resume_csvs):
    from mmdti_tpu_torch import MolTrain
    from mmdti_tpu_torch.train.checkpointing import load_checkpoint

    threads = one_thread()
    try:
        train_p, val_p = resume_csvs
        whole = MolTrain(**_resume_kwargs(str(tmp_path / "whole"), pretrained_dirs)).fit(
            train_p, val_p)
        parted = str(tmp_path / "parted")
        MolTrain(**_resume_kwargs(parted, pretrained_dirs, stop_after_epoch=2)).fit(train_p,
                                                                                    val_p)
        resumed = MolTrain(**_resume_kwargs(parted, pretrained_dirs, resume=True)).fit(train_p,
                                                                                       val_p)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(resumed.cv_pred, whole.cv_pred)
    a = flax_params_to_state_dict(load_checkpoint(str(tmp_path / "whole"), 0)["params"])
    b = flax_params_to_state_dict(load_checkpoint(parted, 0)["params"])
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_resume_with_another_freeze_is_refused(tmp_path, pretrained_dirs, resume_csvs):
    from mmdti_tpu_torch import MolTrain

    threads = one_thread()
    try:
        train_p, val_p = resume_csvs
        exp = str(tmp_path / "parted")
        MolTrain(**_resume_kwargs(exp, pretrained_dirs, stop_after_epoch=1)).fit(train_p, val_p)
        with pytest.raises(ValueError, match="freeze_layers"):
            MolTrain(**_resume_kwargs(exp, pretrained_dirs, resume=True,
                                      freeze_layers="embed_tokens.")).fit(train_p, val_p)
    finally:
        torch.set_num_threads(threads)
