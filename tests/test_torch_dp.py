"""Data parallelism (mmdti_tpu_torch/parallel/mesh.py) on the CPU: two
processes in a gloo group (tests/torch_dp_worker.py, spawned as
tests/test_distributed_dcn.py spawns its workers), SMALL_ARCH width
(2 Uni-Mol layers, width 32), fp32, torch on one thread.

* Against the JAX package: a regression fit with InfoNCE, CT, FDS and
  sample weights on, every dropout 0, batch 8 split 4 + 4 over the two
  ranks, from the JAX initial weights: cv_pred equals the JAX package's
  single-process fit at the fit tolerances (1e-5 abs / 1e-4 rel), the
  two ranks equal each other at 1e-6 (bit for bit here).
* Port two ranks against port one process (no group) on the fits whose
  loss has a batch-wide denominator: NaN-masked multilabel (focal), fed
  from the host (each rank's rows of a batch collated whole), and GHM
  (its bin state) as a 2-fold CV fit: cv_pred and history at the same
  tolerances.
* The global-batch gradient of one step: each rank's gradient, averaged
  over the ranks, is the one-process gradient of the whole batch.
* Dropout: the ranks draw independent masks for identical rows (the twin
  of tests/test_pallas_mesh.py::test_data_shards_draw_independent_masks),
  and rank 0 draws what a fit without a group draws.
* The single-writer rule: rank 0 wrote model_0.ckpt, config.yaml, the
  history, the scaler and the train state; rank 1 opened nothing for
  writing.  A two-rank fit with dropout, stopped after epoch 1 and
  resumed from rank 0's train state, finishes bit-equal to the
  uninterrupted two-rank fit (each rank's generator stream restored).
* batch_size rounded up to a multiple of the data axis with its warning;
  the two ranks as one model row (1, 2); the meshes refused: a data axis
  other than the group's, more processes or devices than there are.
* MolServe(mesh_shape=(2, 1), device="cpu") on the experiment dir the two
  ranks wrote: the single-replica server's answers and the JAX
  MolServe(mesh_shape=(8, 1))'s at the serve tolerance, buckets
  multiples of 2, embed the same, /health reports the mesh.
"""

import functools
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import mmdti_tpu.models.mm_model as jax_mm
import mmdti_tpu.train.nnmodel as jax_nnmodel
import mmdti_tpu_torch.models.mm_model as port_mm
from mmdti_tpu_torch.models.convert import flax_params_to_state_dict
from tests.conftest import SMALL_ARCH, SMILES_20
from tests.test_torch_fit import _fit_kwargs, split_csvs
from tests.test_torch_fit_multilabel import T1, T2, T2_FULL
from tests.test_torch_train import PAD, SMILES_VOCAB, V, _batch
from tests.torch_task_parity import PRED_ATOL, PRED_RTOL, fit_kwargs, one_thread, task_csvs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
HIST_KEYS = ("train_loss", "m_loss", "infonce_loss", "ct_loss", "val_loss")
# SMALL_ARCH's widths with the flagship's dropouts
DROPOUT_ARCH = {name: {k: v for k, v in SMALL_ARCH[name].items() if "dropout" not in k}
                for name in ("unimol_overrides", "chemberta_overrides")}


# the ranks' work, started beside the one-process fits, must end within this
RANKS_DEADLINE_S = 900


def _start_ranks(tmp, spec_path):
    """The two ranks, meeting through a rendezvous file in ``tmp``; each
    one's output goes to a file (a pipe nobody reads while the one-process
    fits run could fill and stop a rank)."""
    env = dict(os.environ, MMDTI_DISABLE_FILE_LOG="1")
    rendezvous = "file://" + str(tmp / "rendezvous")
    procs = []
    for r in range(2):
        with open(tmp / f"rank{r}.out", "w") as out, open(tmp / f"rank{r}.err", "w") as err:
            procs.append(subprocess.Popen([sys.executable, WORKER, str(r), rendezvous, spec_path],
                                          env=env, stdout=out, stderr=err))
    return procs


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _join_ranks(tmp, procs, deadline):
    """Wait for both ranks until ``deadline`` (time.monotonic()); on a
    failure or a timeout stop both and report both ranks' stderr."""
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        failed = any(p.returncode != 0 for p in procs)
        what = "a rank failed"
    except subprocess.TimeoutExpired:
        failed, what = True, f"the ranks did not finish within {RANKS_DEADLINE_S} s"
    finally:
        _stop(procs)
    if failed:
        report = [f"rank {r} (rc {p.returncode}):\n{(tmp / f'rank{r}.err').read_text()[-6000:]}"
                  for r, p in enumerate(procs)]
        pytest.fail(f"{what}\n" + "\n".join(report))


def _port_fit(kwargs, data):
    """The port's one-process fit (no group), InfoNCE's query dropout 0."""
    from mmdti_tpu_torch import MolTrain

    mp = pytest.MonkeyPatch()
    mp.setattr(port_mm, "InfoNCE", functools.partial(port_mm.InfoNCE, embed_dropout=0.0))
    try:
        clf = MolTrain(**kwargs, device="cpu").fit(*data)
    finally:
        mp.undo()
    with open(os.path.join(kwargs["save_path"], "history_0.json")) as f:
        return {"cv_pred": np.asarray(clf.cv_pred, np.float64), "hist": json.load(f)}


def _jax_fit(kwargs, data):
    """The JAX package's fit (its single process, the 8-device test mesh),
    InfoNCE's query dropout 0; returns its cv_pred and initial weights
    under the port's names."""
    from mmdti_tpu import MolTrain as JaxTrain

    captured = {}
    real_init = jax_nnmodel.NNModel._init_params

    def init(self, params):
        captured["params"] = real_init(self, params)
        return captured["params"]

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_mm, "InfoNCE", functools.partial(jax_mm.InfoNCE, embed_dropout=0.0))
    mp.setattr(jax_nnmodel.NNModel, "_init_params", init)
    try:
        fit = JaxTrain(**kwargs).fit(*data)
    finally:
        mp.undo()
    return np.asarray(fit.cv_pred, np.float64), flax_params_to_state_dict(captured["params"])


def _one_process_grad(spec):
    """The flat gradient of one step on the whole batch, no group."""
    from mmdti_tpu_torch.losses.registry import resolve_loss
    from mmdti_tpu_torch.train.steps import build_train_loss
    from tests.torch_dp_worker import _model

    model = _model(spec)
    batch = np.load(spec["batch"])
    feats = {k: torch.from_numpy(batch[k]) for k in spec["feat_keys"]}
    loss = build_train_loss(resolve_loss("regression", None), "regression")
    total, metrics = loss(model, feats, torch.from_numpy(batch["labels"]),
                          torch.from_numpy(batch["weights"]), None)
    params = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(total, params, allow_unused=True)
    g = torch.cat([(torch.zeros_like(p) if d is None else d).reshape(-1)
                   for p, d in zip(params, grads)])
    return {"loss": float(total.detach()), "infonce": float(metrics["infonce_loss"]),
            "grad": g.numpy()}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX fit, then the two ranks' work (gradient, masks, trainer
    checks, three fits) beside the port's one-process fits and gradient."""
    threads = one_thread()
    tmp = tmp_path_factory.mktemp("dp")
    exps = tmp / "exps"
    reg_dir, ml_dir, ghm_dir = tmp / "reg", tmp / "ml", tmp / "ghm"
    for d in (reg_dir, ml_dir, ghm_dir):
        d.mkdir()
    reg_data = split_csvs(reg_dir)
    ml_data = task_csvs(ml_dir, {"t1": T1, "t2": T2})
    ghm_data = task_csvs(ghm_dir, {"t1": T1, "t2": T2_FULL})[:1]    # CV: no validation set
    try:
        jax_pred, init = _jax_fit(_fit_kwargs(reg_data[0], str(tmp / "jax_exp")), reg_data)
        init_path = str(tmp / "init.pt")
        torch.save(init, init_path)
        feats, labels, weights = _batch()
        batch_path = str(tmp / "batch.npz")
        np.savez(batch_path, labels=labels, weights=weights, **feats)
        ml_kw = fit_kwargs("multilabel_classification", ["t1", "t2"], "auc", "")
        # focal through the host branch (2 batches stacked a dispatch), GHM
        # as a 2-fold CV fit (the folds in lockstep on both ranks)
        ghm_kw = dict(ml_kw, loss_key="ghm", kfold=2)
        ml_kw.update(device_feed=False, steps_per_call=2)
        # dropout on (each rank its own stream), a train state every epoch
        drop_kw = dict(_fit_kwargs(reg_data[0], ""), checkpoint_interval=1,
                       crossmodal_overrides={}, **DROPOUT_ARCH)
        spec = {
            "exp_root": str(exps), "out": str(tmp / "rank{rank}.json"),
            "batch": batch_path, "feat_keys": sorted(feats), "vocab": V, "pad": PAD,
            "smiles_vocab": SMILES_VOCAB, "unimol": SMALL_ARCH["unimol_overrides"],
            "chemberta": SMALL_ARCH["chemberta_overrides"],
            "fits": {
                "reg": {"kwargs": _fit_kwargs(reg_data[0], str(exps / "reg")),
                        "data": list(reg_data), "init": init_path,
                        "infonce_dropout_off": True},
                "multilabel": {"kwargs": dict(ml_kw, save_path=str(exps / "ml")),
                               "data": list(ml_data), "infonce_dropout_off": True},
                "ghm": {"kwargs": dict(ghm_kw, save_path=str(exps / "ghm")),
                        "data": list(ghm_data), "infonce_dropout_off": True},
                "whole": {"kwargs": dict(drop_kw, save_path=str(exps / "whole")),
                          "data": list(reg_data)},
                "stopped": {"kwargs": dict(drop_kw, save_path=str(exps / "resumed"),
                                           stop_after_epoch=1), "data": list(reg_data)},
                "resumed": {"kwargs": dict(drop_kw, save_path=str(exps / "resumed"),
                                           resume=True), "data": list(reg_data)},
            },
        }
        spec_path = str(tmp / "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        deadline = time.monotonic() + RANKS_DEADLINE_S
        procs = _start_ranks(tmp, spec_path)
        try:
            # the one-process runs while the ranks work
            single = {"grad": _one_process_grad(spec),
                      "multilabel": _port_fit(dict(ml_kw, save_path=str(tmp / "ml_exp")),
                                              ml_data),
                      "ghm": _port_fit(dict(ghm_kw, save_path=str(tmp / "ghm_exp")), ghm_data)}
        except BaseException:
            _stop(procs)
            raise
        _join_ranks(tmp, procs, deadline)
        ranks = []
        for r in range(2):
            with open(spec["out"].format(rank=r)) as f:
                ranks.append(json.load(f))
        yield {"jax_pred": jax_pred, "ranks": ranks, "single": single, "spec": spec}
    finally:
        torch.set_num_threads(threads)


def _fit_pred(dp, name, rank):
    return np.asarray(dp["ranks"][rank]["fits"][name]["cv_pred"])


def test_two_ranks_match_the_jax_fit(dp):
    """InfoNCE, CT, FDS and sample weights, the global batch split over two
    ranks: the JAX package's single-process predictions."""
    a, b = _fit_pred(dp, "reg", 0), _fit_pred(dp, "reg", 1)
    assert dp["ranks"][0]["backend"] == "gloo" and dp["ranks"][0]["size"] == 2
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert a.shape == dp["jax_pred"].shape
    np.testing.assert_allclose(a, dp["jax_pred"], atol=PRED_ATOL, rtol=PRED_RTOL)
    h0, h1 = (dp["ranks"][r]["fits"]["reg"]["hist"] for r in range(2))
    for x, y in zip(h0, h1):
        for k in (*HIST_KEYS, "val_mse"):
            assert x[k] == y[k], k


@pytest.mark.parametrize("name", ["multilabel", "ghm"])
def test_two_ranks_match_one_process(dp, name):
    """Losses whose denominator is the batch's (NaN-masked focal, GHM's bin
    counts): two ranks fit what one process fits on the whole batch."""
    single = dp["single"][name]
    for rank in range(2):
        got = _fit_pred(dp, name, rank)
        np.testing.assert_allclose(got, single["cv_pred"], atol=PRED_ATOL, rtol=PRED_RTOL)
        hist = dp["ranks"][rank]["fits"][name]["hist"]
        assert len(hist) == len(single["hist"]) == 2
        for x, y in zip(hist, single["hist"]):
            for k in (*HIST_KEYS, "val_auc"):
                np.testing.assert_allclose(x[k], y[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_global_batch_gradient_identity(dp):
    """Each rank sees half the rows; the loss of the gathered batch and the
    average of the ranks' gradients are the one-process loss and gradient
    of the whole batch, the same on both ranks."""
    single = dp["single"]["grad"]
    g = [dp["ranks"][r]["grad"] for r in range(2)]
    for rank in g:
        np.testing.assert_allclose(rank["loss"], single["loss"], rtol=1e-6)
        np.testing.assert_allclose(rank["infonce"], single["infonce"], rtol=1e-6)
        np.testing.assert_allclose(rank["averaged"], single["grad"], atol=1e-6, rtol=1e-5)
    assert g[0]["averaged"] == g[1]["averaged"]
    local = np.asarray([r["local"] for r in g])
    # each rank alone holds W times its rows' share, not the gradient
    assert not np.allclose(local[0], single["grad"], atol=1e-4)
    np.testing.assert_allclose(local.mean(axis=0), single["grad"], atol=1e-6, rtol=1e-5)


def test_ranks_draw_independent_dropout_masks(dp):
    from mmdti_tpu_torch.models.layers import draw_seed
    from mmdti_tpu_torch.ops.dropout import keep_mask

    d0, d1 = (dp["ranks"][r]["dropout"] for r in range(2))
    assert d0["mask"] != d1["mask"], "the ranks' attention masks are correlated"
    l0, l1 = np.asarray(d0["logits"]), np.asarray(d1["logits"])
    assert not np.allclose(l0, l1), "identical rows gave identical outputs on both ranks"
    # rank 0 keeps the fit's seed: what one process draws
    seed = draw_seed(torch.Generator().manual_seed(42), 0.1)
    assert keep_mask(seed, 0.1, 2, 4, 8, 8).int().tolist() == d0["mask"]


def test_only_rank_zero_writes(dp):
    wrote = [set(dp["ranks"][r]["writes"]) for r in range(2)]
    assert wrote[1] == set(), wrote[1]
    for name, fit in (("reg", "reg"), ("ml", "multilabel"), ("ghm", "ghm")):
        for f in ("config.yaml", "history_0.json", "model_0.ckpt.tmp"):
            assert f"{name}/{f}" in wrote[0], (name, f)
        exp = os.path.join(dp["spec"]["exp_root"], name)
        assert os.path.exists(os.path.join(exp, "model_0.ckpt"))
    assert "reg/target_scaler.ss" in wrote[0]
    assert "ml/threshold.dat" in wrote[0]


def test_resume_under_a_group_continues_each_ranks_stream(dp):
    """Dropout on, a train state each epoch: stopped after epoch 1 and
    resumed, the two ranks finish as the uninterrupted two-rank fit, bit
    for bit; rank 0's train state holds both ranks' generator states."""
    from mmdti_tpu_torch.train.checkpointing import load_train_state

    for rank in range(2):
        whole = dp["ranks"][rank]["fits"]["whole"]
        resumed = dp["ranks"][rank]["fits"]["resumed"]
        assert resumed["cv_pred"] == whole["cv_pred"]
        strip = [{k: v for k, v in r.items() if "seconds" not in k} for r in whole["hist"]]
        assert [{k: v for k, v in r.items() if "seconds" not in k}
                for r in resumed["hist"]] == strip
    # the ranks' dropout differs: their losses do not (the loss is the
    # global batch's), but their streams do
    state = load_train_state(os.path.join(dp["spec"]["exp_root"], "resumed"), 0)
    streams = state["programs"]["rank_generators"]
    assert len(streams) == 2 and not torch.equal(streams[0], streams[1])
    assert torch.equal(streams[0], state["programs"]["generator"])
    assert not any("train_state" in w for w in dp["ranks"][1]["writes"])
    assert "resumed/train_state_0.ckpt.tmp" in dp["ranks"][0]["writes"]


def test_batch_size_rounds_up_to_the_data_axis(dp):
    for rank in dp["ranks"]:
        checks = rank["trainer"]
        assert checks["batch_size"] == 8
        assert checks["warnings"] == [
            "batch_size 7 is not divisible by the 2-way data mesh axis; rounding up to 8"]
        assert checks["data_1"].startswith("ValueError: mesh_shape (1, 1): a fit's data axis")
        # the two ranks as one model row (tensor parallelism, tests/test_torch_tp.py)
        assert checks["model_2"] == {"data": [0, 1], "model": [rank["rank"], 2]}
        assert rank["fits"]["reg"]["batch_size"] == 8


@pytest.mark.parametrize("shape,devices,err,match", [
    ((1, 2), None, ValueError, "needs 2 processes; only 1 available"),
    ((2, 1), None, ValueError, "needs 2 processes; only 1 available"),
    ((2, 1), ["cpu"], ValueError, "needs 2 devices; only 1 available"),
])
def test_meshes_refused(shape, devices, err, match):
    from mmdti_tpu_torch.parallel.mesh import make_mesh
    from mmdti_tpu_torch.train.trainer import Trainer

    with pytest.raises(err, match=match):
        make_mesh(shape, devices)
    if devices is None:
        with pytest.raises(err, match=match):
            Trainer(device="cpu", task="regression", mesh_shape=shape)


def test_predict_ignores_the_mesh_a_fit_trained_on(dp, tmp_path):
    """A dir whose config names the two-rank mesh of its fit predicts in
    one process as the same dir without it."""
    import shutil

    from mmdti_tpu_torch import MolPredict
    from mmdti_tpu_torch.configs.config import load_yaml, save_yaml

    exp = os.path.join(dp["spec"]["exp_root"], "reg")
    meshed = str(tmp_path / "meshed")
    shutil.copytree(exp, meshed)
    cfg = load_yaml(os.path.join(meshed, "config.yaml"))
    cfg["mesh_shape"] = [2, 1]
    save_yaml(cfg, os.path.join(meshed, "config.yaml"))
    val = dp["spec"]["fits"]["reg"]["data"][1]
    got = MolPredict(load_model=meshed, device="cpu").predict(val)
    want = MolPredict(load_model=exp, device="cpu").predict(val)
    np.testing.assert_array_equal(got, want)


def test_one_process_mesh_has_no_group():
    from mmdti_tpu_torch.train.trainer import Trainer

    t = Trainer(device="cpu", task="regression", mesh_shape=(1, 1), batch_size=7)
    assert t.data_group is None and t.mesh.shape == {"data": 1, "model": 1}
    assert t.batch_size == 7


@pytest.fixture(scope="module")
def served(dp):
    from mmdti_tpu import MolServe as JaxServe
    from mmdti_tpu_torch import MolServe

    exp = os.path.join(dp["spec"]["exp_root"], "reg")
    one = MolServe(exp, device="cpu")
    meshed = MolServe(exp, device="cpu", mesh_shape=(2, 1))
    jax_meshed = JaxServe(exp, mesh_shape=(8, 1))
    return {"one": one, "meshed": meshed,
            "answers": {k: s.predict(SMILES_20) for k, s in
                        (("one", one), ("meshed", meshed), ("jax", jax_meshed))},
            "embed": {k: s.embed(SMILES_20) for k, s in
                      (("one", one), ("meshed", meshed), ("jax", jax_meshed))}}


def test_meshed_server_answers_as_one_replica_and_jax(served):
    meshed = served["meshed"]
    assert len(meshed.replica_devices) == 2 and meshed.mesh.shape == {"data": 2, "model": 1}
    assert all(b % 2 == 0 for b in meshed.batch_buckets)
    got = served["answers"]["meshed"]
    for ref in ("one", "jax"):
        want = served["answers"][ref]
        assert got["predict"].shape == want["predict"].shape == (20, 1)
        np.testing.assert_allclose(got["predict"], want["predict"], atol=PRED_ATOL,
                                   rtol=PRED_RTOL, err_msg=ref)
        np.testing.assert_array_equal(got["valid"], want["valid"])
    for ref in ("one", "jax"):
        for a, b in zip(served["embed"]["meshed"], served["embed"][ref]):
            np.testing.assert_allclose(a, b, atol=PRED_ATOL, rtol=PRED_RTOL, err_msg=ref)
    # a request smaller than a bucket: the padded rows stay out
    small = meshed.predict(SMILES_20[:3])["predict"]
    np.testing.assert_allclose(small, got["predict"][:3], atol=PRED_ATOL, rtol=PRED_RTOL)


def test_health_reports_the_mesh(served):
    srv = served["meshed"].make_server(port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/health"
        with urllib.request.urlopen(url, timeout=60) as r:
            body = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    assert body["mesh"] == {"data": 2, "model": 1}
