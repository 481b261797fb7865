"""Encoder remat (mmdti_tpu_torch/models/unimol.py, train/nnmodel.py) on
the CPU: SMALL_ARCH widths with every Uni-Mol dropout on (activation
dropout too), fp32, torch on one thread.

* One train step with remat on is bit-equal to one without: the loss,
  every gradient, the parameters after the optimizer update and the
  generator's state after the step; on the kernel path (the kernels' plain
  versions on CPU tensors) and the oracle path.  The layers really run
  again in the backward: pair-bias attention is called twice a layer.
* Under torch.no_grad and torch.inference_mode the checkpoint is never
  entered (a serving or eval forward keeps its launches) and the output
  is the one without remat.
* The automatic decision: NNModel on the CPU turns remat on exactly where
  the JAX package's NNModel does (its XLA path's atom pad 160) for a few
  (batch, atom_pad) pairs, logging the JAX message; an explicit
  ``remat`` in unimol_overrides wins both ways.
* The card's rule is a function of the total memory it is given.
"""

import logging
import types

import numpy as np
import pytest
import torch

import mmdti_tpu.train.nnmodel as jax_nnmodel
import mmdti_tpu_torch.models.unimol as port_unimol
import mmdti_tpu_torch.train.nnmodel as port_nnmodel
from mmdti_tpu_torch.configs.architectures import UniMolEncoderConfig
from mmdti_tpu_torch.losses import zoo
from mmdti_tpu_torch.models.mm_model import build_model
from mmdti_tpu_torch.train.optim import FusedAdam
from mmdti_tpu_torch.train.steps import build_train_step
from tests.conftest import SMALL_ARCH
from tests.test_torch_train import PAD, SMILES_VOCAB, V, _batch
from tests.torch_task_parity import one_thread

DROPOUTS = {"dropout": 0.1, "emb_dropout": 0.1, "attention_dropout": 0.1,
            "activation_dropout": 0.1}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = one_thread()
    yield
    torch.set_num_threads(threads)


def _model(remat, use_kernels=True):
    model = build_model(
        output_dim=1, atom_vocab_size=V, atom_pad_idx=PAD, smiles_vocab_size=SMILES_VOCAB,
        compute_dtype="float32", use_kernels=use_kernels,
        unimol_overrides={**SMALL_ARCH["unimol_overrides"], **DROPOUTS, "remat": remat},
        chemberta_overrides=dict(SMALL_ARCH["chemberta_overrides"], max_position_embeddings=40))
    return model.reset_parameters_like_flax(torch.Generator().manual_seed(0))


def _feats():
    feats, labels, weights = _batch()
    return ({k: torch.from_numpy(v) for k, v in feats.items()}, torch.from_numpy(labels),
            torch.from_numpy(weights))


def _count_pair_calls(monkeypatch):
    calls = []
    real = port_unimol.pair_bias_attention

    def counted(*args, **kwargs):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(port_unimol, "pair_bias_attention", counted)
    return calls


def _step(remat, use_kernels, monkeypatch):
    model = _model(remat, use_kernels)
    calls = _count_pair_calls(monkeypatch)
    opt = FusedAdam(dict(model.named_parameters()), 1e-3, 10)
    grads = {}
    real_apply = opt.apply

    def apply(g):
        grads.update({k: v.clone() for k, v in g.items() if v is not None})
        return real_apply(g)

    opt.apply = apply
    step = build_train_step(model, opt, zoo.mse_loss, "regression")
    gen = torch.Generator().manual_seed(3)
    metrics = step(*_feats(), gen)
    monkeypatch.undo()
    return {"metrics": {k: v.clone() for k, v in metrics.items()}, "grads": grads,
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "generator": gen.get_state(), "calls": len(calls)}


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_path", "oracle_path"])
def test_remat_step_is_bit_equal_to_the_step_without(use_kernels, monkeypatch):
    off = _step(False, use_kernels, monkeypatch)
    on = _step(True, use_kernels, monkeypatch)
    layers = SMALL_ARCH["unimol_overrides"]["encoder_layers"]
    assert off["calls"] == layers and on["calls"] == 2 * layers
    assert off["metrics"].keys() == on["metrics"].keys()
    for k in off["metrics"]:
        assert torch.equal(off["metrics"][k], on["metrics"][k]), k
    assert off["grads"].keys() == on["grads"].keys() and len(off["grads"]) > 0
    for k in off["grads"]:
        assert torch.equal(off["grads"][k], on["grads"][k]), k
    for k in off["params"]:
        assert torch.equal(off["params"][k], on["params"][k]), k
    assert torch.equal(off["generator"], on["generator"])


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_a_forward_without_autograd_does_not_checkpoint(mode, monkeypatch):
    feats, _, _ = _feats()
    off, on = _model(False), _model(True)

    def refuse(*args, **kwargs):
        raise AssertionError("a forward without autograd entered the checkpoint")

    monkeypatch.setattr(port_unimol, "checkpoint", refuse)
    ctx = torch.no_grad if mode == "no_grad" else torch.inference_mode
    with ctx():
        a = off(**feats, outputs="train", deterministic=False,
                generator=torch.Generator().manual_seed(5))["logits"]
        b = on(**feats, outputs="train", deterministic=False,
               generator=torch.Generator().manual_seed(5))["logits"]
    assert torch.equal(a, b)


class _Stop(Exception):
    pass


def _decided(module, monkeypatch, **kw):
    """The unimol_overrides a package's NNModel builds its model with, for a
    fixed atom pad (max_atoms + 2 rounded up to 16) and a batch size; the
    build itself is cut short."""
    seen = {}

    def build(**kwargs):
        seen.update(kwargs.get("unimol_overrides") or {})
        raise _Stop

    monkeypatch.setattr(module, "build_model", build)
    data = {"unimol_input": [], "target_scaler": None, "num_classes": 1}
    params = dict(task="regression", pad_mode="fixed", max_atoms=kw["max_atoms"],
                  compute_dtype="float32", unimol_overrides=kw.get("overrides") or {})
    if module is jax_nnmodel:
        trainer = types.SimpleNamespace(save_path=None, batch_size=kw["batch"], mesh=None)
    else:
        from mmdti_tpu_torch.train.trainer import Trainer

        trainer = Trainer(device="cpu", task="regression", batch_size=kw["batch"])
    with pytest.raises(_Stop):
        module.NNModel(data, data, trainer, **params)
    monkeypatch.undo()
    return seen.get("remat", False)


@pytest.mark.parametrize("batch,max_atoms", [(8, 142), (8, 158), (32, 158), (32, 174),
                                             (256, 62)])
def test_cpu_decision_equals_the_jax_package(batch, max_atoms, monkeypatch, caplog):
    jax_on = _decided(jax_nnmodel, monkeypatch, batch=batch, max_atoms=max_atoms)
    with caplog.at_level(logging.INFO, logger="mmdti_tpu_torch"):
        port_on = _decided(port_nnmodel, monkeypatch, batch=batch, max_atoms=max_atoms)
    assert port_on == jax_on == (-(-(max_atoms + 2) // 16) * 16 >= 160)
    atom_pad = -(-(max_atoms + 2) // 16) * 16
    logged = f"Auto-enabled encoder rematerialization (atom_pad={atom_pad})"
    assert (logged in caplog.text) == port_on


@pytest.mark.parametrize("remat", [False, True])
def test_an_explicit_remat_wins(remat, monkeypatch):
    for max_atoms in (62, 174):
        kw = dict(batch=8, max_atoms=max_atoms, overrides={"remat": remat})
        assert _decided(port_nnmodel, monkeypatch, **kw) is remat
        assert _decided(jax_nnmodel, monkeypatch, **kw) is remat


def test_card_rule_reads_the_total_memory():
    """The card's rule compares the predicted peak without remat with a share
    of the memory it is given (no 80 GB is assumed)."""
    cfg = UniMolEncoderConfig(pair_dtype="bfloat16")
    need = port_nnmodel.predicted_step_bytes(32, 280, 64, cfg)
    assert port_nnmodel.predicted_step_bytes(32, 280, 64, cfg, remat=True) < need
    assert port_nnmodel.predicted_step_bytes(64, 280, 64, cfg) > need
    cuda = torch.device("cuda", 0)
    share = port_nnmodel.REMAT_MEMORY_SHARE
    for total, on in ((int(need / share) - 1, True), (int(need / share) + 1, False)):
        assert port_nnmodel.auto_remat({"pair_dtype": "bfloat16"}, 280, 64, 32, cuda,
                                       total_memory=total) is on
    # a MOF model has no SMILES stream
    assert port_nnmodel.predicted_step_bytes(16, 528, 0, cfg) < \
        port_nnmodel.predicted_step_bytes(16, 528, 64, cfg)
    np.testing.assert_equal(port_nnmodel.auto_remat({}, 160, 64, 8, torch.device("cpu")), True)
