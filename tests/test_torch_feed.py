"""mmdti_tpu_torch's device-resident feed, K-step dispatches and gradient
accumulation on the CPU, against the JAX package and against the port's
own host loop:

* ``normalize_device_feed`` against the JAX package's on the spellings of
  tests/test_train.py::TestDeviceFeedNormalization (exact), and the
  Trainer's knobs with their JAX defaults;
* ``epoch_index_matrix``, ``row_bucket`` and ``collate_dataset`` against the
  JAX package's on the same seed and features (exact);
* port fits at (device_feed, steps_per_call) = (True, 1), (True, 4) and
  (True, 3, snapped to 2) against (False, 1), 4 batches of 4 an epoch, 2
  epochs, dropout on: the same history, checkpoint predictions and
  MolPredict output, exactly (on the CPU every setting runs the same steps
  in the same order, drawing the same dropout masks from one generator);
* ``accumulate_steps=2`` against the JAX fit with the same setting (1e-5 on
  predictions, 1e-5 relative on the history), and the identity of
  tests/test_train.py::TestGradAccumulation: 2 mini-steps of batch 8 equal
  one update at batch 16 (atol 2e-4, rtol 1e-3: the same math with the
  gradient sums in another order, JAX's tolerance); both with the losses
  that decompose over rows, as the identity needs (the full loss is held
  to JAX by tests/test_torch_fit.py);
* FusedAdam with its counts on the device against the host-count update it
  replaced, five steps, bit-equal;
* MolPredict through the resident sweep against the per-batch path (1e-6,
  as tests/test_end_to_end.py), on 20 SMILES in batches of 8 (a padded
  last batch);
* device_feed=True with pad_mode='bucket' raises.

Shared with tests/test_torch_fit.py: SMALL_ARCH, the 20-SMILES split and
the JAX-parity patches.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch
import yaml

from mmdti_tpu.configs.config import load_yaml as jax_load_yaml
from mmdti_tpu.data.batching import BatchCollator as JaxCollator
from mmdti_tpu.data.batching import MolDataLoader as JaxLoader
from mmdti_tpu.data.batching import MolDataset as JaxDataset
from mmdti_tpu.data.batching import collate_dataset as jax_collate_dataset
from mmdti_tpu.train.trainer import Trainer as JaxTrainer
from mmdti_tpu.train.trainer import _normalize_device_feed as jax_normalize
from mmdti_tpu_torch.chem.conformer import ConformerGen
from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
from mmdti_tpu_torch.data.batching import (
    BatchCollator,
    MolDataLoader,
    MolDataset,
    collate_dataset,
    dataset_pad_lengths,
)
from mmdti_tpu_torch.train.device_feed import normalize_device_feed, row_bucket
from mmdti_tpu_torch.train.optim import FusedAdam, _bias_correction
from mmdti_tpu_torch.train.trainer import Trainer
from tests.conftest import SMALL_ARCH, SMILES_20
from tests.test_torch_fit import _fit_kwargs, jax_parity_patches, split_csvs



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The fits here are many tiny operations: with a thread pool each
    they slow down many times over beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- knobs ----------------------------------------------------------------------

SPELLINGS = ["auto", "AUTO", " Auto ", "true", "on", "1", "yes", 1, True, "false", "off", "0",
             "no", "", 0, False, None]


@pytest.mark.parametrize("value", SPELLINGS, ids=repr)
def test_normalize_device_feed_equals_jax(value):
    got = normalize_device_feed(value)
    want = jax_normalize(value)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("value", ["maybe", 1.5, [True]], ids=repr)
def test_unknown_device_feed_raises_as_in_jax(value):
    with pytest.raises(ValueError, match="device_feed"):
        jax_normalize(value)
    with pytest.raises(ValueError, match="device_feed"):
        normalize_device_feed(value)
    with pytest.raises(ValueError, match="device_feed"):
        Trainer(task="regression", metrics="mse", device="cpu", device_feed=value)


@pytest.mark.parametrize("params", [{}, dict(steps_per_call=3, device_feed="off",
                                             device_feed_bytes=1234, accumulate_steps=2)],
                         ids=["defaults", "set"])
def test_trainer_knobs_match_jax(params):
    ours = Trainer(task="regression", metrics="mse", device="cpu", **params)
    theirs = JaxTrainer(task="regression", metrics="mse", **params)
    for knob in ("steps_per_call", "steps_per_call_explicit", "device_feed",
                 "device_feed_bytes", "accumulate_steps"):
        assert getattr(ours, knob) == getattr(theirs, knob), knob


# ---- loaders and collation ----------------------------------------------------------

@pytest.mark.parametrize("n,bs,shuffle,drop_last", [(20, 8, True, True), (20, 8, True, False),
                                                    (21, 4, False, False), (16, 4, True, True)])
def test_epoch_index_matrix_equals_jax(n, bs, shuffle, drop_last):
    labels = np.zeros((n, 1), np.float32)
    ours = MolDataLoader(MolDataset([{}] * n, labels), bs, None, shuffle=shuffle,
                         drop_last=drop_last, seed=7)
    theirs = JaxLoader(JaxDataset([{}] * n, labels), bs, None, shuffle=shuffle,
                       drop_last=drop_last, seed=7)
    for _ in range(3):   # the shuffle advances per epoch in both
        (a, na), (b, nb) = ours.epoch_index_matrix(), theirs.epoch_index_matrix()
        assert a.dtype == b.dtype == np.int32 and na == nb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 200, 256, 1000])
def test_row_bucket_equals_jax(n):
    assert row_bucket(n) == JaxTrainer._row_bucket(n)


@pytest.fixture(scope="module")
def features():
    feats = ConformerGen().transform(SMILES_20)
    for f, s in zip(feats, SMILES_20):
        f["smile"] = s
    return feats


@pytest.mark.parametrize("mode", ["dataset", "fixed"])
def test_collate_dataset_equals_jax(features, mode):
    from mmdti_tpu.chem.tokenizer import SmilesTokenizer as JaxTokenizer

    labels = np.random.RandomState(1).randn(len(features), 1).astype(np.float32)
    atom, smi = dataset_pad_lengths(features, SmilesTokenizer())
    ours = collate_dataset(MolDataset(features, labels), BatchCollator(
        SmilesTokenizer(), 1, mode, atom_pad=atom, smiles_pad=smi), chunk=8)
    theirs = jax_collate_dataset(JaxDataset(features, labels), JaxCollator(
        JaxTokenizer(), 1, mode, atom_pad=atom, smiles_pad=smi), chunk=8)
    assert set(ours[0]) == set(theirs[0])
    for k in ours[0]:
        assert ours[0][k].dtype == theirs[0][k].dtype, k
        np.testing.assert_array_equal(ours[0][k], theirs[0][k], err_msg=k)
    np.testing.assert_array_equal(ours[1], theirs[1])
    with pytest.raises(ValueError, match="static pad_mode"):
        collate_dataset(MolDataset(features, labels), BatchCollator(SmilesTokenizer(), 1,
                                                                    "bucket"))


# ---- the port's fits under every dispatch setting -------------------------------------

FEED_SETTINGS = [(False, 1), (True, 1), (True, 4), (True, 3)]


def _port_fit(train_p, val_p, exp, **kw):
    """A port fit at SMALL_ARCH, fp32, 2 epochs; dropout stays on in the
    cross-modal layers and InfoNCE.  Returns (history, cv_pred, MolPredict
    on val)."""
    from mmdti_tpu_torch import MolPredict, MolTrain

    args = dict(task="regression", epochs=2, learning_rate=1e-3, batch_size=4,
                early_stopping=5, metrics="mse", smiles_col="smiles", save_path=exp,
                target_cols=["measured"], using_infonce=True, using_ct=True, raw_data=train_p,
                use_weight=True, fds=True, fds_num=8, fds_raw_path=train_p,
                fds_col_data="measured", seed=42, compute_dtype="float32", mu_dtype="float32",
                device="cpu", unimol_overrides=SMALL_ARCH["unimol_overrides"],
                chemberta_overrides=SMALL_ARCH["chemberta_overrides"])
    args.update(kw)
    fit = MolTrain(**args).fit(train_p, val_p)
    with open(os.path.join(exp, "history_0.json")) as f:
        hist = json.load(f)
    pred = MolPredict(load_model=exp, device="cpu").predict(val_p)
    return hist, np.asarray(fit.cv_pred), np.asarray(pred)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture(scope="module")
def feed_fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("feed")
    train_p, val_p = split_csvs(tmp)
    out = {}
    log = logging.getLogger("mmdti_tpu_torch")
    for feed, spc in FEED_SETTINGS:
        lines = _Lines()
        log.addHandler(lines)
        level = log.level
        log.setLevel(logging.INFO)
        try:
            exp = str(tmp / f"exp_{feed}_{spc}")
            out[(feed, spc)] = (*_port_fit(train_p, val_p, exp, device_feed=feed,
                                           steps_per_call=spc), lines.lines, exp)
        finally:
            log.removeHandler(lines)
            log.setLevel(level)
    return out


def _without_times(hist):
    return [{k: v for k, v in row.items() if k not in ("seconds", "val_seconds")}
            for row in hist]


@pytest.mark.parametrize("setting", FEED_SETTINGS[1:], ids=str)
def test_feed_and_steps_per_call_give_the_same_fit(feed_fits, setting):
    hist, cv_pred, pred, lines, _ = feed_fits[setting]
    ref_hist, ref_cv, ref_pred, ref_lines, _ = feed_fits[(False, 1)]
    assert _without_times(hist) == _without_times(ref_hist)
    np.testing.assert_array_equal(cv_pred, ref_cv)
    np.testing.assert_array_equal(pred, ref_pred)
    assert any("device_feed engaged" in s for s in lines)
    assert not any("device_feed engaged" in s for s in ref_lines)
    snapped = [s for s in lines if "does not divide" in s]
    if setting == (True, 3):
        assert snapped == ["steps_per_call 3 does not divide the 4-batch epoch; using 2 per "
                           "dispatch (avoids a second graph for the trailing block)"]
    else:
        assert not snapped


def test_knobs_round_trip_through_config_yaml(feed_fits):
    exp = feed_fits[(True, 3)][4]
    path = os.path.join(exp, "config.yaml")
    with open(path) as f:
        raw = yaml.safe_load(f)
    assert raw["steps_per_call"] == 3 and raw["device_feed"] is True
    cfg = jax_load_yaml(path).to_dict()
    assert Trainer(device="cpu", **cfg).steps_per_call == JaxTrainer(**cfg).steps_per_call == 3


# ---- gradient accumulation ------------------------------------------------------------

# the identity needs losses that decompose over rows: no InfoNCE negatives,
# no CT pairs, no FDS statistics (as tests/test_train.py::TestGradAccumulation)
ROW_LOSSES = dict(using_infonce=False, using_ct=False, use_weight=False, fds=False)


@pytest.fixture(scope="module")
def accumulate_fits(tmp_path_factory):
    """From one set of initial parameters (the JAX fit first: the port
    starts from its parameters), the row losses only, 32 train rows and 2
    epochs: accumulate_steps=2 at batch 8 in both packages, and the port at
    batch 16 without accumulation."""
    from mmdti_tpu import MolTrain as JaxTrain
    from mmdti_tpu_torch import MolTrain

    tmp = tmp_path_factory.mktemp("accumulate")
    train_p, val_p = split_csvs(tmp, SMILES_20 * 2, n_train=32, seed=5)
    cpu = {"device": "cpu"}
    out = {}
    with jax_parity_patches():
        for name, cls, extra in (("jax", JaxTrain, {}), ("port", MolTrain, cpu),
                                 ("port_b16", MolTrain, {**cpu, "batch_size": 16,
                                                         "accumulate_steps": 1})):
            exp = str(tmp / f"exp_{name}")
            kw = {**_fit_kwargs(train_p, exp), **ROW_LOSSES, "accumulate_steps": 2, **extra}
            fit = cls(**kw).fit(train_p, val_p)
            with open(os.path.join(exp, "history_0.json")) as f:
                out[name] = (json.load(f), np.asarray(fit.cv_pred))
    return out


def test_accumulate_steps_matches_jax(accumulate_fits):
    (jh, jp), (ph, pp) = accumulate_fits["jax"], accumulate_fits["port"]
    np.testing.assert_allclose(pp, jp, atol=1e-5)
    assert len(jh) == len(ph) == 2
    for a, b in zip(jh, ph):
        for k in ("val_loss", "val_mse", "train_loss", "m_loss", "infonce_loss", "ct_loss"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)


def test_accumulation_matches_one_large_batch(accumulate_fits):
    acc, big = accumulate_fits["port"][1], accumulate_fits["port_b16"][1]
    assert acc.shape == big.shape
    np.testing.assert_allclose(acc, big, atol=2e-4, rtol=1e-3)


# ---- the optimizer's device counts ----------------------------------------------------

def _host_schedule(learning_rate, num_training_steps, warmup_ratio, step):
    """The learning rate at ``step`` as the host schedule took it."""
    f32 = np.float32
    num_warmup = int(num_training_steps * warmup_ratio)
    step = f32(step)
    warm = step / f32(max(1.0, num_warmup))
    decay = (f32(num_training_steps) - step) / f32(max(1.0, num_training_steps - num_warmup))
    factor = warm if step < num_warmup else decay
    return f32(learning_rate) * f32(np.clip(factor, f32(0.0), f32(1.0)))


def _host_count_update(opt, g, count, schedule_count, schedule):
    """The update as it was with the counts on the host: the bias
    corrections and the step size as host floats of numpy float32 values.
    Returns the new (count, schedule_count)."""
    f32 = np.float32
    if opt._trained is not None:
        g = torch.where(opt._trained, g, torch.zeros(()))
    g_norm = torch.sqrt(torch.sum(g * g))
    g = torch.where(g_norm < opt.max_norm, g, (g / g_norm) * opt.max_norm)
    count += 1
    bc1 = float(f32(1.0) - f32(opt.b1) ** f32(count))
    bc2 = float(f32(1.0) - f32(opt.b2) ** f32(count))
    step_size = float(-schedule(schedule_count))
    mu = (1 - opt.b1) * g + opt._mu * torch.tensor(opt.b1, dtype=opt._mu.dtype)
    nu = (1 - opt.b2) * (g * g) + opt.b2 * opt._nu
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + opt.eps)
    opt._flat.add_(step_size * u)
    opt._mu.copy_(mu)
    opt._nu.copy_(nu)
    return count, schedule_count + 1


@pytest.mark.parametrize("mu_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("frozen", [False, True])
def test_device_counts_equal_the_host_count_update(mu_dtype, frozen):
    """Five updates (warmup, then decay; the clip triggers on the large
    gradients), from a state carried in at count 3: bit-equal to the host
    arithmetic, counts included."""
    rng = np.random.RandomState(0)

    def params():
        return {"a": torch.from_numpy(rng.randn(6, 4).astype(np.float32)),
                "b": torch.from_numpy(rng.randn(5).astype(np.float32))}

    p_dev = params()
    p_host = {k: v.clone() for k, v in p_dev.items()}
    sched = dict(learning_rate=1e-2, num_training_steps=8, warmup_ratio=0.25)
    kw = dict(**sched, max_norm=1.0, frozen={"b"} if frozen else None, mu_dtype=mu_dtype)
    dev, host = FusedAdam(p_dev, **kw), FusedAdam(p_host, **kw)
    state = dev.state
    for n in state.mu:
        state.mu[n].copy_(torch.from_numpy(rng.rand(*state.mu[n].shape).astype(np.float32)))
        state.nu[n].copy_(torch.from_numpy(rng.rand(*state.nu[n].shape).astype(np.float32)))
    state.count, state.schedule_count = 3, 2
    dev.load_state(state)
    host.load_state(state)
    count, sched_count = 3, 2
    for i in range(5):
        scale = 10.0 if i % 2 == 0 else 0.05
        grads = {n: scale * torch.sin(p * (i + 1)) for n, p in p_dev.items()}
        dev.apply(grads)
        g = torch.cat([grads[n].reshape(-1) for n in p_host]).float()
        count, sched_count = _host_count_update(
            host, g, count, sched_count, lambda step: _host_schedule(**sched, step=step))
    assert torch.equal(dev._flat, host._flat)
    assert torch.equal(dev._mu, host._mu) and torch.equal(dev._nu, host._nu)
    assert (dev.state.count, dev.state.schedule_count) == (count, sched_count) == (8, 7)


def test_bias_correction_table_ends_at_one():
    for b in (0.9, 0.999):
        table = _bias_correction(b)
        assert table[-1] == np.float32(1.0) and table[-2] != np.float32(1.0)
        assert table[0] == np.float32(0.0)


# ---- bulk predict and the static-padding rule -------------------------------------------

def test_molpredict_sweep_matches_per_batch_path(feed_fits, tmp_path):
    """20 SMILES in batches of 8 (the fit's batch size is 4; predict here
    at 8 through the config): the sweep's padded last batch included."""
    from mmdti_tpu_torch import MolPredict
    from mmdti_tpu_torch.data.reader import write_csv

    exp = feed_fits[(True, 4)][4]
    data = str(tmp_path / "all.csv")
    write_csv({"smiles": np.asarray(SMILES_20, object),
               "measured": np.linspace(-1.0, 1.0, len(SMILES_20))}, data)
    preds = {}
    for feed in ("auto", False):
        p = MolPredict(load_model=exp, device="cpu")
        p.config["batch_size"] = 8
        p.config["device_feed"] = feed
        preds[feed] = p.predict(data)
        assert bool(p.trainer._sweeps) == (feed == "auto")
    assert preds["auto"].shape == (len(SMILES_20), 1)
    np.testing.assert_allclose(preds["auto"], preds[False], atol=1e-6)


def test_device_feed_true_requires_static_padding(tmp_path):
    from mmdti_tpu_torch import MolTrain

    train_p, val_p = split_csvs(tmp_path)
    m = MolTrain(task="regression", epochs=1, batch_size=8, metrics="mse", smiles_col="smiles",
                 save_path=str(tmp_path / "exp"), target_cols=["measured"], seed=0,
                 compute_dtype="float32", use_pallas=False, device_feed=True,
                 pad_mode="bucket", device="cpu", **SMALL_ARCH)
    with pytest.raises(ValueError, match="static padding"):
        m.fit(train_p, val_p)
