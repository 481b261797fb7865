"""mmdti_tpu_torch's mid-fit resume, train state and fit profiler on the
CPU (the twins of tests/test_train.py's resume cases and
tests/test_end_to_end.py's profiler case):

* ``stop_after_epoch=2`` then ``resume=True`` continues the uninterrupted
  port fit bit for bit (every history scalar, the final weights, the
  predictions), with dropout on: for regression with FDS and sample
  weights, for multilabel_classification with GHM (its bins and flag in
  the train state), and with ``accumulate_steps=2`` stopped in the middle
  of an accumulation; a resume after an abort right after a train-state
  save too;
* the uninterrupted port fit equals the JAX package's fit at the fit
  parity tolerance (tests/torch_task_parity.py);
* a truncated train state and a JAX-written one abort the resume;
* the train-state codec, FusedAdam's state with its accumulation buffers,
  GHM's state and the loader's ``advance_epochs`` round-trip;
* ``profile_dir`` writes a Chrome trace of the first dispatches,
  ``debug_nans`` raises FloatingPointError at a non-finite loss, and
  ``checkpoint_backend="orbax"`` and a ``mesh_shape`` with a model axis (tensor
  parallelism) still raise.

Torch runs on one thread.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

from tests.conftest import SMALL_ARCH, SMILES_20
from tests.test_torch_fit import NO_DROPOUT, jax_parity_patches
from tests.torch_task_parity import HIST_KEYS, PRED_ATOL, PRED_RTOL, one_thread

DROPOUT = dict(unimol_overrides={**SMALL_ARCH["unimol_overrides"], "dropout": 0.1},
               chemberta_overrides=SMALL_ARCH["chemberta_overrides"])
REGRESSION = dict(task="regression", metrics="mse", target_cols=["y"], use_weight=True,
                  fds=True, fds_num=8)
MULTILABEL = dict(task="multilabel_classification", metrics="auc", target_cols=["a", "b"],
                  loss_key="ghm")
COMMON = dict(epochs=4, learning_rate=1e-3, batch_size=4, early_stopping=10, smiles_col="smiles",
              using_infonce=True, using_ct=True, seed=0, compute_dtype="float32",
              use_pallas=False, device="cpu", **SMALL_ARCH)


@pytest.fixture(scope="module", autouse=True)
def threads():
    saved = one_thread()
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    rng = np.random.RandomState(3)
    labels = (rng.rand(len(SMILES_20), 2) > 0.5).astype(float)
    df = pd.DataFrame({"smiles": SMILES_20, "y": rng.randn(len(SMILES_20)),
                       "a": labels[:, 0], "b": labels[:, 1]})
    df.loc[16:17, "a"] = [0.0, 1.0]
    df.loc[16:17, "b"] = [1.0, 0.0]
    train, val = str(tmp / "train.csv"), str(tmp / "val.csv")
    df.iloc[:16].to_csv(train, index=False)
    df.iloc[16:].to_csv(val, index=False)
    return train, val


def _rows(exp):
    with open(os.path.join(exp, "history_0.json")) as f:
        return json.load(f)


def _fit(exp, csvs, **kw):
    from mmdti_tpu_torch import MolTrain

    kw = {**COMMON, **kw}
    if kw["task"] == "regression":
        kw.setdefault("raw_data", csvs[0])
    return MolTrain(save_path=exp, **kw).fit(*csvs)


def _scalars(row):
    return {k: v for k, v in row.items() if k not in ("seconds", "val_seconds")}


def _assert_same_trajectory(a, b, exp_a, exp_b):
    rows = _rows(exp_a)
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in rows)
    assert [_scalars(r) for r in rows] == [_scalars(r) for r in _rows(exp_b)]
    np.testing.assert_array_equal(a.cv_pred, b.cv_pred)
    sa, sb = a.model.model.state_dict(), b.model.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory, csvs):
    tmp = tmp_path_factory.mktemp("whole")
    out = {}
    for name, task in (("regression", REGRESSION), ("multilabel", MULTILABEL)):
        exp = str(tmp / name)
        out[name] = (_fit(exp, csvs, **task, **DROPOUT), exp)
    return out


@pytest.mark.parametrize("task", ["regression", "multilabel"])
def test_resume_continues_the_uninterrupted_fit(uninterrupted, csvs, tmp_path, task):
    spec = REGRESSION if task == "regression" else MULTILABEL
    exp = str(tmp_path / "stopped")
    first = _fit(exp, csvs, stop_after_epoch=2, checkpoint_interval=1, **spec, **DROPOUT)
    assert [r["epoch"] for r in _rows(exp)] == [1, 2]
    saves = first.trainer.state_saves
    assert [(s["epoch"], s["async"]) for s in saves] == [(1, True), (2, False)]
    assert saves[-1]["bytes"] == os.path.getsize(os.path.join(exp, "train_state_0.ckpt"))
    resumed = _fit(exp, csvs, resume=True, checkpoint_interval=1, **spec, **DROPOUT)
    assert [r["epoch"] for r in _rows(exp)] == [1, 2, 3, 4]
    _assert_same_trajectory(uninterrupted[task][0], resumed, uninterrupted[task][1], exp)
    if task == "multilabel":
        a, b = uninterrupted[task][0].model.stateful_loss, resumed.model.stateful_loss
        assert torch.equal(a.bin_count, b.bin_count) and float(b.flag) == 1.0


def test_resume_inside_an_accumulation(csvs, tmp_path):
    """accumulate_steps=2 over 3 batches an epoch: epoch 1 ends between
    the two mini-steps of an update, so the train state carries a
    half-filled running mean."""
    kw = dict(REGRESSION, batch_size=5, accumulate_steps=2, **DROPOUT)
    whole = _fit(str(tmp_path / "whole"), csvs, **kw)
    exp = str(tmp_path / "stopped")
    first = _fit(exp, csvs, stop_after_epoch=1, **kw)
    assert int(first.trainer._last_programs[2].optimizer._mini) == 1
    resumed = _fit(exp, csvs, resume=True, **kw)
    _assert_same_trajectory(whole, resumed, str(tmp_path / "whole"), exp)


def test_resume_after_an_abort(uninterrupted, csvs, tmp_path, monkeypatch):
    """The run dies right after epoch 2's train state lands (no stop, no
    best checkpoint); a resume still continues the uninterrupted fit."""
    from mmdti_tpu_torch.train.trainer import Trainer

    real = Trainer._save_epoch_state

    class Killed(BaseException):
        pass

    def save_then_die(self, saver, dump_dir, fold, epoch, *a, **kw):
        out = real(self, saver, dump_dir, fold, epoch, *a, **kw)
        if epoch == 1:
            saver.wait()
            raise Killed()
        return out

    exp = str(tmp_path / "aborted")
    monkeypatch.setattr(Trainer, "_save_epoch_state", save_then_die)
    with pytest.raises(Killed):
        _fit(exp, csvs, checkpoint_interval=1, **REGRESSION, **DROPOUT)
    monkeypatch.undo()
    assert not os.path.exists(os.path.join(exp, "model_0.ckpt"))
    resumed = _fit(exp, csvs, resume=True, **REGRESSION, **DROPOUT)
    _assert_same_trajectory(uninterrupted["regression"][0], resumed,
                            uninterrupted["regression"][1], exp)


def test_corrupt_train_state_aborts_the_resume(csvs, tmp_path):
    from mmdti_tpu_torch.train.checkpointing import train_state_path

    exp = str(tmp_path / "exp")
    _fit(exp, csvs, epochs=2, checkpoint_interval=1, **REGRESSION)
    path = train_state_path(exp, 0)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 3])
    with pytest.raises(ValueError, match="not a readable train state"):
        _fit(exp, csvs, resume=True, **REGRESSION)


def test_jax_train_state_is_refused(tmp_path):
    import flax.serialization

    from mmdti_tpu_torch.train.checkpointing import load_train_state, train_state_path

    tree = {"params": {"w": np.ones(3, np.float32)},
            "opt_state": {"0": {"mu": {"w": np.zeros(3, np.float32)}}},
            "fds": {}, "epoch": np.asarray(1), "global_step": np.asarray(4)}
    with open(train_state_path(str(tmp_path), 0), "wb") as f:
        f.write(flax.serialization.msgpack_serialize(tree))
    with pytest.raises(ValueError, match="JAX package's train state"):
        load_train_state(str(tmp_path), 0)


def test_uninterrupted_fit_matches_jax(csvs, tmp_path):
    """The trajectory a resume reproduces is the JAX package's: 2 epochs of
    the regression fit (no dropout, fp32 moments) in both packages."""
    from mmdti_tpu import MolTrain as JaxTrain
    from mmdti_tpu_torch import MolTrain

    kw = {**COMMON, **REGRESSION, "epochs": 2, "batch_size": 8, "mu_dtype": "float32",
          "raw_data": csvs[0], "checkpoint_interval": 1, **NO_DROPOUT}
    kw.pop("device")
    fits = {}
    with jax_parity_patches():
        for name, cls, dev in (("jax", JaxTrain, {}), ("port", MolTrain, {"device": "cpu"})):
            exp = str(tmp_path / name)
            fits[name] = (cls(save_path=exp, **kw, **dev).fit(*csvs), _rows(exp))
    np.testing.assert_allclose(fits["port"][0].cv_pred, fits["jax"][0].cv_pred,
                               atol=PRED_ATOL, rtol=PRED_RTOL)
    for a, b in zip(fits["jax"][1], fits["port"][1]):
        for k in (*HIST_KEYS, "val_mse"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
    assert os.path.exists(str(tmp_path / "port" / "train_state_0.ckpt"))


def test_train_state_codec_round_trip(tmp_path):
    from mmdti_tpu_torch.train.checkpointing import load_train_state, save_train_state

    g = torch.Generator().manual_seed(5)
    state = {"programs": {"optimizer": {"mu": torch.randn(6, generator=g).bfloat16(),
                                        "counts": torch.tensor([3, 2])},
                          "generator": g.get_state()},
             "epoch": 2, "global_step": 9, "best_params": {"a.weight": torch.randn(2, 3)},
             "early_stop": {"min_val_loss": float("inf"), "wait": 1,
                            "best_score": float("nan")}}
    n = save_train_state(str(tmp_path), 0, state)
    back = load_train_state(str(tmp_path), 0)
    assert n == os.path.getsize(str(tmp_path / "train_state_0.ckpt"))
    mu = back["programs"]["optimizer"]["mu"]
    assert mu.dtype == torch.bfloat16 and torch.equal(mu, state["programs"]["optimizer"]["mu"])
    assert torch.equal(back["programs"]["generator"], g.get_state())
    assert torch.equal(back["best_params"]["a.weight"], state["best_params"]["a.weight"])
    assert back["epoch"] == 2 and back["early_stop"]["wait"] == 1
    assert np.isinf(back["early_stop"]["min_val_loss"])
    assert np.isnan(back["early_stop"]["best_score"])


def test_adam_state_carries_the_accumulation():
    """FusedAdam.load_state restores the moments, the counts, and
    MultiSteps' running mean and mini-step count, in place; reset zeroes
    all but the parameters."""
    from mmdti_tpu_torch.train.optim import FusedAdam

    def make():
        params = {"w": torch.nn.Parameter(torch.ones(4)), "b": torch.nn.Parameter(torch.zeros(2))}
        return FusedAdam(params, 1e-2, 10, accumulate_steps=3), params

    a, pa = make()
    for i in range(4):
        a.apply({"w": torch.full((4,), float(i + 1)), "b": torch.ones(2)})
    b, pb = make()
    acc_ptr = b._acc.data_ptr()
    b.load_state(a.state)
    with torch.no_grad():
        pb["w"].copy_(pa["w"])
        pb["b"].copy_(pa["b"])
    assert b._acc.data_ptr() == acc_ptr and int(b._mini) == int(a._mini) == 1
    for opt in (a, b):
        opt.apply({"w": torch.full((4,), 7.0), "b": torch.ones(2)})
        opt.apply({"w": torch.full((4,), 8.0), "b": torch.ones(2)})
    for x, y in zip(a.graph_state, b.graph_state):
        assert torch.equal(x, y)
    b.reset()
    assert int(b._mini) == 0 and not b._acc.any() and not b._mu.float().any()
    assert b.state.count == 0 and torch.equal(b._flat, a._flat)


def test_ghm_state_and_loader_skip():
    from mmdti_tpu_torch.data.batching import MolDataLoader, MolDataset
    from mmdti_tpu_torch.losses.zoo import GHMCState

    ghm = GHMCState("cpu")
    ghm(torch.randn(8, 2), (torch.rand(8, 2) > 0.5).float())
    saved = {k: v.clone() for k, v in ghm.state_dict().items()}
    other = GHMCState("cpu")
    ptr = other.bin_count.data_ptr()
    other.load_state_dict(saved)
    assert other.bin_count.data_ptr() == ptr and torch.equal(other.bin_count, ghm.bin_count)
    assert float(other.flag) == 1.0

    ds = MolDataset([{"i": i} for i in range(10)])
    whole = MolDataLoader(ds, 4, None, shuffle=True, seed=3)
    orders = [whole.epoch_index_matrix()[0] for _ in range(3)]
    skipped = MolDataLoader(ds, 4, None, shuffle=True, seed=3)
    skipped.advance_epochs(2)
    np.testing.assert_array_equal(skipped.epoch_index_matrix()[0], orders[2])


def test_profile_dir_writes_a_trace(csvs, tmp_path):
    trace = str(tmp_path / "trace")
    clf = _fit(str(tmp_path / "exp"), csvs, epochs=1, profile_dir=trace, profile_steps=2,
               **REGRESSION)
    files = os.listdir(trace)
    assert files == ["fold0.pt.trace.json"]
    with open(os.path.join(trace, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert clf.trainer.profile_steps == 2


def test_trace_annotate_and_timer(tmp_path):
    """The profiler module's other names: span() is one shared no-op while
    no profiler records, and a named region in the Chrome trace of one that
    does; StepTimer sums up its dispatches."""
    from mmdti_tpu_torch.train.profiler import StepTimer, span, trace_file

    assert span("mmdti_region") is span("other")
    with span("mmdti_region"):
        torch.ones(4).add_(1)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with span("mmdti_region"):
            torch.ones(4).add_(1)
    prof.export_chrome_trace(trace_file(str(tmp_path), "block"))
    with open(trace_file(str(tmp_path), "block")) as f:
        events = json.load(f)["traceEvents"]
    regions = [e for e in events if e.get("name") == "mmdti_region"]
    assert len(regions) == 1 and regions[0]["cat"] == "user_annotation"
    assert span("mmdti_region") is span("other")
    timer = StepTimer()
    for _ in range(3):
        timer.start()
        timer.stop(torch.ones(2))
    summary = timer.summary()
    assert summary["steps"] == 3 and 0 <= summary["p50_s"] <= summary["p95_s"]


def test_debug_nans_raises_at_a_non_finite_loss(csvs, tmp_path):
    table = pd.read_csv(csvs[0])
    table.loc[5, "y"] = np.nan
    bad = str(tmp_path / "bad.csv")
    table.to_csv(bad, index=False)
    kw = dict(task="regression", metrics="mse", target_cols=["y"], epochs=1,
              target_anomaly_check="none", use_scaler=False)
    with pytest.raises(FloatingPointError, match="epoch 1, step"):
        _fit(str(tmp_path / "exp"), (bad, csvs[1]), debug_nans=True, **kw)


@pytest.mark.parametrize("kw,err,match", [
    (dict(checkpoint_backend="orbax"), NotImplementedError, "ROADMAP.md"),
    # a model axis runs: over its processes, one per GPU (tests/test_torch_tp.py)
    (dict(mesh_shape=(1, 2)), ValueError, "needs 2 processes; only 1 available: start one "
                                          "process per GPU"),
], ids=["orbax", "mesh"])
def test_tpu_knobs_still_raise(kw, err, match):
    from mmdti_tpu_torch.train.trainer import Trainer

    with pytest.raises(err, match=match):
        Trainer(device="cpu", task="regression", **kw)
