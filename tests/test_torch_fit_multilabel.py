"""Multilabel classification through the port's MolTrain.fit ->
MolPredict on the CPU against the JAX package's, on the same data and
initial weights (tests/torch_task_parity.py), InfoNCE + CT_Multi,
metrics="auc":

* focal loss (the task's default) with NaN labels and
  threshold_search=True: history and early-stop metric (1e-5), cv_pred
  and predictions (1e-5 abs / 1e-4 rel), the searched per-column
  thresholds in threshold.dat (each package reads the other's), the
  predict CSV and the JAX MolPredict on the port's experiment dir;
* loss_key="ghm" (its EMA bin counts carried across steps; GHM does not
  mask NaN labels in either package, so these labels have none): history
  and predictions as above;
* GHMCState against the JAX package's GHM-C state threading over three
  batches (loss, bin counts and logits gradient, 1e-6);
* TrainPrograms with GHMCState: K stacked steps and K fed steps leave the
  parameters, the optimizer's moments and counts, the metric sums and the
  bin state bit-equal to K single steps, and the loss state is part of
  what a graph capture restores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdti_tpu.losses import zoo as jax_zoo
from mmdti_tpu_torch.losses import zoo
from mmdti_tpu_torch.models.mm_model import build_model
from mmdti_tpu_torch.train.optim import FusedAdam
from mmdti_tpu_torch.train.steps import Resident, TrainPrograms
from tests.conftest import SMALL_ARCH
from tests.test_torch_train import PAD, SMILES_VOCAB, V, _batch
from tests.torch_task_parity import (
    assert_csv_equal,
    assert_history_equal,
    assert_jax_predicts_port_experiment,
    assert_predictions_equal,
    assert_thresholds_equal,
    both_fits,
    one_thread,
)

NAN = float("nan")
T1 = [1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1]
T2 = [0, 0, 1, 1, 1, 0, NAN, 0, 1, 0, 0, 1, 1, 0, 1, NAN, 0, 1, 1, 0]
T2_FULL = [0, 0, 1, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 0, 1, 0, 0, 1, 1, 0]


@pytest.fixture(scope="module")
def focal_fits(tmp_path_factory):
    threads = one_thread()
    try:
        yield both_fits(tmp_path_factory.mktemp("focal"), "multilabel_classification",
                        {"t1": T1, "t2": T2}, "auc", threshold_search=True)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ghm_fits(tmp_path_factory):
    threads = one_thread()
    try:
        yield both_fits(tmp_path_factory.mktemp("ghm"), "multilabel_classification",
                        {"t1": T1, "t2": T2_FULL}, "auc", loss_key="ghm")
    finally:
        torch.set_num_threads(threads)


def test_focal_history_matches_jax(focal_fits):
    assert_history_equal(focal_fits, "auc")
    assert np.isfinite(focal_fits["port"]["hist"][-1]["train_loss"])


def test_focal_predictions_match_jax(focal_fits):
    assert_predictions_equal(focal_fits)
    pred = focal_fits["port"]["pred"]
    assert pred.shape == (4, 2) and ((pred >= 0) & (pred <= 1)).all()


def test_searched_thresholds_match_jax(focal_fits):
    ours, theirs = assert_thresholds_equal(focal_fits)
    assert np.shape(ours) == (2,) and isinstance(theirs, np.ndarray)


def test_focal_predict_csv_matches_jax(focal_fits, tmp_path):
    assert_csv_equal(focal_fits)
    assert {"prob_t1", "prob_t2", "predict_t1", "predict_t2"} <= set(
        focal_fits["port"]["csv"].columns)
    assert_jax_predicts_port_experiment(focal_fits, tmp_path)


def test_ghm_fit_matches_jax(ghm_fits):
    assert_history_equal(ghm_fits, "auc")
    assert_predictions_equal(ghm_fits)
    assert_csv_equal(ghm_fits)
    assert np.isfinite(ghm_fits["port"]["hist"][-1]["m_loss"])


def test_ghm_state_matches_jax_state_threading():
    rng = np.random.RandomState(3)
    state = zoo.GHMCState("cpu")
    jax_bins = None
    for step in range(3):
        x = (rng.randn(16, 3) * 2).astype(np.float32)
        y = rng.randint(0, 2, (16, 3)).astype(np.float32)

        def jax_loss(logits):
            return jax_zoo.ghmc_loss(logits, jnp.asarray(y), jax_bins)

        (want, bins), want_g = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        got = state(xt, torch.from_numpy(y))
        (got_g,) = torch.autograd.grad(got, xt)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(state.bin_count.numpy(), np.asarray(bins), rtol=1e-6)
        assert float(state.flag) == 1.0
        jax_bins = bins
    state.reset()
    assert not state.bin_count.any() and float(state.flag) == 0.0


K = 3


def _programs():
    torch.manual_seed(0)
    model = build_model(output_dim=2, atom_vocab_size=V, atom_pad_idx=PAD,
                        smiles_vocab_size=SMILES_VOCAB, compute_dtype="float32",
                        unimol_overrides=SMALL_ARCH["unimol_overrides"],
                        chemberta_overrides=dict(SMALL_ARCH["chemberta_overrides"],
                                                 max_position_embeddings=40))
    model.reset_parameters_like_flax(torch.Generator().manual_seed(1))
    opt = FusedAdam(dict(model.named_parameters()), 1e-3, 10)
    loss = zoo.GHMCState("cpu")
    progs = TrainPrograms(model, opt, loss, "multilabel_classification",
                          torch.Generator().manual_seed(2), use_ct=True, use_weight=False)
    return model, opt, loss, progs


def _steps_data():
    feats, _, weights = _batch()
    feats = {k: torch.from_numpy(v) for k, v in feats.items()}
    rng = np.random.RandomState(4)
    labels = torch.from_numpy(rng.randint(0, 2, (K, 4, 2)).astype(np.float32))
    return feats, labels, torch.from_numpy(weights)


def _state(model, opt, loss, progs):
    return ([t.clone() for t in model.state_dict().values()]
            + [t.clone() for t in opt.graph_state]
            + [progs.metric_sums.clone(), loss.bin_count.clone(), loss.flag.clone()])


@pytest.mark.parametrize("variant", ["stacked", "feed"])
def test_ghm_state_through_k_step_programs_equals_single_steps(variant):
    feats, labels, weights = _steps_data()
    model, opt, loss, progs = _programs()
    singles = torch.stack([progs.single(feats, labels[k], weights) for k in range(K)])
    want = _state(model, opt, loss, progs)

    model, opt, loss, progs = _programs()
    assert progs.loss_state == (loss.bin_count, loss.flag)
    if variant == "stacked":
        got_m = progs.stacked({k: v.expand(K, *v.shape) for k, v in feats.items()}, labels,
                              weights.expand(K, *weights.shape))
    else:
        res = Resident({k: v.repeat(K, *([1] * (v.dim() - 1))) for k, v in feats.items()},
                       labels.reshape(K * 4, 2), weights.repeat(K, 1))
        got_m = progs.feed(res, torch.arange(K * 4).view(K, 4))
    assert torch.equal(got_m, singles)
    got = _state(model, opt, loss, progs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(loss.flag) == 1.0 and float(loss.bin_count.sum()) > 0
