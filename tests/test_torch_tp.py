"""Tensor parallelism (mmdti_tpu_torch/parallel/mesh.py, the model axis) on
the CPU: gloo groups of two and four processes (tests/torch_tp_worker.py,
spawned as tests/test_torch_dp.py spawns its workers), SMALL_ARCH width,
fp32, torch on one thread.

* Against the JAX package: a (1, 2) fit (InfoNCE, CT, FDS and sample
  weights on, every dropout 0, from the JAX initial weights) equals the
  JAX MolTrain(mesh_shape=(4, 2)) fit at the fit tolerances (1e-5 abs /
  1e-4 rel); the two model ranks' predictions are bit-equal.
* A (2, 2) fit on four ranks equals the port's fit without a group.
* Dropout on: a (1, 2) fit with every dropout at its default equals the
  one-process fit with dropout on (the masks are the same), and the
  replicated parameters end bit-equal on the two model ranks.
* Stopped after epoch 1 and resumed, that fit finishes bit-equal to the
  uninterrupted one; only rank 0 writes; its model_0.ckpt (the whole
  model) loads into the JAX MolPredict.
* Layers: shard -> gather of a flagship state dict is exact; one step's
  gradient on the kernel path, gathered over the two model ranks, equals
  the one-process gradient at 1e-5, gbf's parameters included.
* Serving: MolServe(mesh_shape=(1, 2)) and (2, 2) on the CPU equal the
  JAX MolServe(mesh_shape=(4, 2)); embed is the same at every mesh;
  serve_folds="all" with a model axis raises.
* Gates: heads, FFN widths or a shard's gbf heads that the model axis
  does not divide raise ValueError naming them.
"""

import functools
import json
import os
import time

import numpy as np
import pytest
import torch

from tests.conftest import SMALL_ARCH, SMILES_20
from tests.test_torch_dp import DROPOUT_ARCH, HIST_KEYS, _jax_fit, _join_ranks, _stop
from tests.test_torch_fit import _fit_kwargs, split_csvs
from tests.test_torch_train import PAD, SMILES_VOCAB, V, _batch
from tests.torch_task_parity import PRED_ATOL, PRED_RTOL, one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
RANKS_DEADLINE_S = 900
# the kernel path at a width whose shards pass the gbf gate (16 heads / 2)
GRAD_UNIMOL = {"encoder_layers": 2, "embed_dim": 64, "ffn_embed_dim": 128,
               "attention_heads": 16, "gaussian_kernels": 32}
GRAD_CHEMBERTA = {"hidden_size": 64, "num_hidden_layers": 1, "num_attention_heads": 4,
                  "intermediate_size": 128}


def _start(tmp, name, world, spec_path):
    import subprocess
    import sys

    env = dict(os.environ, MMDTI_DISABLE_FILE_LOG="1")
    rendezvous = "file://" + str(tmp / f"rendezvous_{name}")
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.out", "w") as out, open(tmp / f"rank{r}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(r), str(world), rendezvous, spec_path],
                env=env, stdout=out, stderr=err))
    return procs


def _spec(tmp, name, fits, **extra):
    spec = {"exp_root": str(tmp / "exps"), "out": str(tmp / "rank{rank}.json"),
            "fits": fits, **extra}
    path = str(tmp / "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return spec, path


def _read(spec, world):
    out = []
    for r in range(world):
        with open(spec["out"].format(rank=r)) as f:
            out.append(json.load(f))
    return out


def _port_fit(kwargs, data, init=None, infonce_dropout_off=True):
    """The port's one-process fit (no group), from the weights at ``init``
    (a state dict file) when given."""
    import mmdti_tpu_torch.models.mm_model as port_mm
    import mmdti_tpu_torch.train.nnmodel as port_nnmodel
    from mmdti_tpu_torch import MolTrain

    mp = pytest.MonkeyPatch()
    if infonce_dropout_off:
        mp.setattr(port_mm, "InfoNCE", functools.partial(port_mm.InfoNCE, embed_dropout=0.0))
    if init is not None:
        sd = torch.load(init, weights_only=True)
        mp.setattr(port_nnmodel.NNModel, "_init_params",
                   lambda self, params: self.model.load_state_dict(sd))
    try:
        clf = MolTrain(**kwargs, device="cpu").fit(*data)
    finally:
        mp.undo()
    with open(os.path.join(kwargs["save_path"], "history_0.json")) as f:
        return {"cv_pred": np.asarray(clf.cv_pred, np.float64), "hist": json.load(f)}


def _one_process_gradient(spec):
    from mmdti_tpu_torch.losses.registry import resolve_loss
    from mmdti_tpu_torch.train.steps import build_train_loss
    from tests.torch_tp_worker import grad_model

    model = grad_model(spec)
    batch = np.load(spec["batch"])
    feats = {k: torch.from_numpy(batch[k]) for k in spec["feat_keys"]}
    loss = build_train_loss(resolve_loss("regression", None), "regression")
    total, _ = loss(model, feats, torch.from_numpy(batch["labels"]),
                    torch.from_numpy(batch["weights"]), None)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in named], allow_unused=True)
    return float(total.detach()), {n: (torch.zeros_like(p) if g is None else g)
                                   for (n, p), g in zip(named, grads)}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The JAX (4, 2) fit; then two ranks (gradient, trainer checks, the
    (1, 2) fits) and four ranks (the (2, 2) fit) beside the port's
    one-process fits and gradient."""
    threads = one_thread()
    root = tmp_path_factory.mktemp("tp")
    data_dir = root / "data"
    data_dir.mkdir()
    data = split_csvs(data_dir)
    two, four = root / "two", root / "four"
    two.mkdir()
    four.mkdir()
    try:
        jax_kw = dict(_fit_kwargs(data[0], str(root / "jax_exp")), mesh_shape=(4, 2))
        jax_pred, init = _jax_fit(jax_kw, data)
        init_path = str(root / "init.pt")
        torch.save(init, init_path)
        feats, labels, weights = _batch()
        batch_path = str(root / "batch.npz")
        np.savez(batch_path, labels=labels, weights=weights, **feats)
        reg = dict(_fit_kwargs(data[0], ""), mesh_shape=(1, 2))
        drop = dict(reg, checkpoint_interval=1, crossmodal_overrides={}, **DROPOUT_ARCH)
        exps = two / "exps"
        spec2, path2 = _spec(two, "two", {
            "reg": {"kwargs": dict(reg, save_path=str(exps / "reg")), "data": list(data),
                    "init": init_path, "infonce_dropout_off": True},
            "whole": {"kwargs": dict(drop, save_path=str(exps / "whole")), "data": list(data)},
            "stopped": {"kwargs": dict(drop, save_path=str(exps / "resumed"),
                                       stop_after_epoch=1), "data": list(data)},
            "resumed": {"kwargs": dict(drop, save_path=str(exps / "resumed"), resume=True),
                        "data": list(data)},
        }, grad=True, batch=batch_path, feat_keys=sorted(feats), vocab=V, pad=PAD,
            smiles_vocab=SMILES_VOCAB, grad_unimol=GRAD_UNIMOL, grad_chemberta=GRAD_CHEMBERTA,
            grad_out=str(two / "grad.pt"))
        dp_tp = dict(reg, epochs=1, mesh_shape=(2, 2))
        spec4, path4 = _spec(four, "four", {
            "dptp": {"kwargs": dict(dp_tp, save_path=str(four / "exps" / "dptp")),
                     "data": list(data), "init": init_path, "infonce_dropout_off": True}})
        deadline = time.monotonic() + RANKS_DEADLINE_S
        procs2 = _start(two, "two", 2, path2)
        procs4 = _start(four, "four", 4, path4)
        try:
            one_kw = {k: v for k, v in dp_tp.items() if k != "mesh_shape"}
            single = {
                "grad": _one_process_gradient(spec2),
                "dptp": _port_fit(dict(one_kw, save_path=str(root / "one_dptp")), data,
                                  init=init_path),
                "dropout": _port_fit(dict({k: v for k, v in drop.items() if k != "mesh_shape"},
                                          save_path=str(root / "one_drop")), data,
                                     infonce_dropout_off=False),
            }
        except BaseException:
            _stop(procs2 + procs4)
            raise
        _join_ranks(two, procs2, deadline)
        _join_ranks(four, procs4, deadline)
        yield {"jax_pred": jax_pred, "two": _read(spec2, 2), "four": _read(spec4, 4),
               "single": single, "spec2": spec2, "data": data,
               "jax_exp": str(root / "jax_exp")}
    finally:
        torch.set_num_threads(threads)


def _pred(ranks, name, rank):
    return np.asarray(ranks[rank]["fits"][name]["cv_pred"])


def test_model_axis_matches_the_jax_tp_fit(tp):
    """(1, 2) against the JAX package's (4, 2) fit from the same weights."""
    a, b = _pred(tp["two"], "reg", 0), _pred(tp["two"], "reg", 1)
    np.testing.assert_array_equal(a, b)
    assert a.shape == tp["jax_pred"].shape
    np.testing.assert_allclose(a, tp["jax_pred"], atol=PRED_ATOL, rtol=PRED_RTOL)
    h0, h1 = (tp["two"][r]["fits"]["reg"]["hist"] for r in range(2))
    for x, y in zip(h0, h1):
        for k in (*HIST_KEYS, "val_mse"):
            assert x[k] == y[k], k


def test_data_by_model_mesh_matches_one_process(tp):
    """(2, 2) on four ranks: the one-process fit on the whole batch."""
    single = tp["single"]["dptp"]
    for rank in range(4):
        got = _pred(tp["four"], "dptp", rank)
        np.testing.assert_allclose(got, single["cv_pred"], atol=PRED_ATOL, rtol=PRED_RTOL)
        hist = tp["four"][rank]["fits"]["dptp"]["hist"]
        for x, y in zip(hist, single["hist"]):
            for k in HIST_KEYS:
                np.testing.assert_allclose(x[k], y[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # the model ranks of a data row, and the data rows, end on one answer
    for rank in range(1, 4):
        np.testing.assert_array_equal(_pred(tp["four"], "dptp", rank),
                                      _pred(tp["four"], "dptp", 0))


def test_dropout_draws_the_one_process_masks(tp):
    """Every dropout at its default: the (1, 2) fit draws the masks one
    process draws, so it fits what one process fits; the replicated
    parameters end bit-equal on both model ranks, the shards differ."""
    single = tp["single"]["dropout"]
    for rank in range(2):
        got = _pred(tp["two"], "whole", rank)
        np.testing.assert_allclose(got, single["cv_pred"], atol=PRED_ATOL, rtol=PRED_RTOL)
        for x, y in zip(tp["two"][rank]["fits"]["whole"]["hist"], single["hist"]):
            for k in HIST_KEYS:
                np.testing.assert_allclose(x[k], y[k], rtol=1e-5, atol=1e-7, err_msg=k)
    f0, f1 = (tp["two"][r]["fits"]["whole"] for r in range(2))
    assert f0["replicated"] == f1["replicated"]
    assert f0["shards"] != f1["shards"]


def test_resume_continues_the_model_axis_fit(tp):
    from mmdti_tpu import MolPredict as JaxPredict
    from mmdti_tpu_torch import MolPredict
    from mmdti_tpu_torch.train.checkpointing import load_train_state

    for rank in range(2):
        whole = tp["two"][rank]["fits"]["whole"]
        resumed = tp["two"][rank]["fits"]["resumed"]
        assert resumed["cv_pred"] == whole["cv_pred"]
        strip = [{k: v for k, v in r.items() if "seconds" not in k} for r in whole["hist"]]
        assert [{k: v for k, v in r.items() if "seconds" not in k}
                for r in resumed["hist"]] == strip
    assert tp["two"][1]["writes"] == []
    assert "resumed/train_state_0.ckpt.tmp" in tp["two"][0]["writes"]
    exp = os.path.join(tp["spec2"]["exp_root"], "resumed")
    # the train state holds the whole model's optimizer buffers
    state = load_train_state(exp, 0)
    n_whole = sum(p.numel() for p in state["best_params"].values())
    assert state["programs"]["optimizer"]["params"].numel() == n_whole
    val = tp["data"][1]
    ours = MolPredict(load_model=exp, device="cpu").predict(val)
    theirs = JaxPredict(load_model=exp).predict(val)
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), atol=PRED_ATOL,
                               rtol=PRED_RTOL)


def test_trainer_under_a_two_rank_group(tp):
    for rank, out in enumerate(tp["two"]):
        t = out["trainer"]
        assert t["shape"] == {"data": 1, "model": 2}
        assert t["data"] == [0, 1] and t["model"] == [rank, 2] and t["batch_size"] == 7
        assert t["refused"].startswith("mesh_shape (1, 1): a fit's data axis times its model")


def test_gathered_gradient_equals_one_process(tp):
    """The kernel path (fused gbf at 8 heads a shard): one step's gradient,
    gathered over the model ranks, is the one-process gradient."""
    loss, want = tp["single"]["grad"]
    got = torch.load(tp["spec2"]["grad_out"], weights_only=True)
    assert set(got) == set(want)
    for rank in tp["two"]:
        np.testing.assert_allclose(rank["loss"], loss, rtol=1e-6)
    for name, g in want.items():
        scale = max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)
    assert any(n.startswith("gbf_proj.linear1") for n in want)
    assert any(n.startswith("gbf.") for n in want)


@pytest.mark.parametrize("m", [2, 4])
def test_shard_then_gather_is_exact(m):
    from mmdti_tpu_torch.models.mm_model import build_model
    from mmdti_tpu_torch.parallel.mesh import gather_state_dicts, shard_state_dict, tp_rule

    model = build_model(output_dim=1, atom_vocab_size=V, atom_pad_idx=PAD, smiles_vocab_size=600)
    sd = model.reset_parameters_like_flax(torch.Generator().manual_seed(0)).state_dict()
    shards = [shard_state_dict(sd, i, m) for i in range(m)]
    whole = gather_state_dicts(shards)
    assert set(whole) == set(sd)
    for k, v in sd.items():
        assert torch.equal(whole[k], v), k
    sharded = [k for k in sd if tp_rule(k)]
    # 15 Uni-Mol layers x 6, 6 ChemBERTa and 2 cross-modal layers x 10, gbf's 2
    assert len(sharded) == 15 * 6 + 6 * 10 + 2 * 10 + 2
    qkv = shards[1]["encoder.layers_0.in_proj.weight"]
    E = sd["encoder.layers_0.in_proj.weight"].shape[1]
    # rank 1 takes its heads of q, of k and of v
    assert torch.equal(qkv[:E // m], sd["encoder.layers_0.in_proj.weight"][E // m:2 * E // m])


@pytest.fixture(scope="module")
def served(tp):
    from mmdti_tpu import MolServe as JaxServe
    from mmdti_tpu_torch import MolServe

    exp = os.path.join(tp["spec2"]["exp_root"], "reg")
    # the plain path, as the fit ran: SMALL_ARCH's 2 heads a shard are below
    # the fused gbf kernel's gate
    servers = {"one": MolServe(exp, device="cpu", use_kernels=False),
               "1x2": MolServe(exp, device="cpu", mesh_shape=(1, 2), use_kernels=False),
               "2x2": MolServe(exp, device="cpu", mesh_shape=(2, 2), use_kernels=False)}
    jax = JaxServe(exp, mesh_shape=(4, 2))
    return {"servers": servers,
            "answers": {k: s.predict(SMILES_20) for k, s in servers.items()},
            "embed": {k: s.embed(SMILES_20) for k, s in servers.items()},
            "jax": jax.predict(SMILES_20), "jax_embed": jax.embed(SMILES_20), "exp": exp}


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_tp_server_answers_as_jax(served, mesh):
    srv = served["servers"][mesh]
    d, m = (int(x) for x in mesh.split("x"))
    assert srv.mesh.shape == {"data": d, "model": m}
    assert len(srv.replica_devices) == d
    got = served["answers"][mesh]
    for ref in (served["jax"], served["answers"]["one"]):
        assert got["predict"].shape == ref["predict"].shape == (20, 1)
        np.testing.assert_allclose(got["predict"], ref["predict"], atol=PRED_ATOL,
                                   rtol=PRED_RTOL)
        np.testing.assert_array_equal(got["valid"], ref["valid"])
    for a, b in zip(served["embed"][mesh], served["embed"]["one"]):
        np.testing.assert_allclose(a, b, atol=PRED_ATOL, rtol=PRED_RTOL)
    for a, b in zip(served["embed"][mesh], served["jax_embed"]):
        np.testing.assert_allclose(a, b, atol=PRED_ATOL, rtol=PRED_RTOL)


def test_fold_ensemble_refuses_a_model_axis(served, tmp_path):
    """A two-fold dir (fold 0's checkpoint twice) serves its ensemble on a
    pure data axis; on a model axis it refuses, as the JAX package does."""
    import shutil

    from mmdti_tpu_torch import MolServe
    from mmdti_tpu_torch.configs.config import load_yaml, save_yaml

    exp = str(tmp_path / "two_folds")
    shutil.copytree(served["exp"], exp)
    shutil.copy(os.path.join(exp, "model_0.ckpt"), os.path.join(exp, "model_1.ckpt"))
    cfg = load_yaml(os.path.join(exp, "config.yaml"))
    cfg["model_folds"] = 2
    save_yaml(cfg, os.path.join(exp, "config.yaml"))
    assert MolServe(exp, device="cpu", serve_folds="all", mesh_shape=(2, 1),
                    use_kernels=False).serve_folds == 2
    with pytest.raises(ValueError, match="tensor-parallel"):
        MolServe(exp, device="cpu", serve_folds="all", mesh_shape=(1, 2), use_kernels=False)


@pytest.mark.parametrize("overrides,kernels,match", [
    ({"unimol_overrides": {**SMALL_ARCH["unimol_overrides"], "attention_heads": 3,
                           "embed_dim": 30}}, False, "Uni-Mol attention_heads"),
    ({"unimol_overrides": {**SMALL_ARCH["unimol_overrides"], "ffn_embed_dim": 65}}, False,
     "Uni-Mol ffn_embed_dim"),
    ({"unimol_overrides": SMALL_ARCH["unimol_overrides"]}, True, "gbf kernel's gate"),
    ({"chemberta_overrides": {**SMALL_ARCH["chemberta_overrides"], "num_attention_heads": 1}},
     False, "ChemBERTa num_attention_heads"),
    ({"crossmodal_overrides": {"intermediate_size": 65}}, False,
     "cross-modal intermediate_size"),
])
def test_indivisible_widths_raise(overrides, kernels, match):
    from mmdti_tpu_torch.models.mm_model import build_model
    from mmdti_tpu_torch.parallel.mesh import ReplicaShards

    kw = {"unimol_overrides": SMALL_ARCH["unimol_overrides"],
          "chemberta_overrides": SMALL_ARCH["chemberta_overrides"], **overrides}
    group = ReplicaShards(["cpu", "cpu"]).handle(0)
    with pytest.raises(ValueError, match=match):
        build_model(output_dim=1, atom_vocab_size=V, atom_pad_idx=PAD,
                    smiles_vocab_size=SMILES_VOCAB, use_kernels=kernels, model_group=group,
                    **kw)


def test_model_axis_needs_its_processes():
    from mmdti_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="needs 2 processes; only 1 available"):
        make_mesh((1, 2))
    mesh = make_mesh((1, 2), ["cpu", "cpu"])
    assert mesh.shape == {"data": 1, "model": 2} and len(mesh.devices) == 2


@pytest.mark.parametrize("kind", ["pair_bias", "masked"])
def test_head_span_drops_what_the_whole_layer_drops(kind):
    """The plain versions of the kernels, dropout on: a call over heads
    4..7 of an 8-head layer (head_span=(4, 8)) computes what the whole
    layer's call computes for those heads, and head_span=(0, H) is the
    call without a span, bit for bit."""
    from mmdti_tpu_torch.ops import hopper_attention as ha

    gen = torch.Generator().manual_seed(5)
    B, N, H, D, h0 = 2, 12, 8, 4, 4
    q, k, v, g = (torch.randn(B, N, H * D, generator=gen) for _ in range(4))
    seed = torch.tensor([1234], dtype=torch.int32)
    cols = slice(h0 * D, H * D)
    if kind == "pair_bias":
        bias = torch.randn(B, H, N, N, generator=gen)
        whole = ha.pair_bias_attention_plain(q, k, v, bias, H, torch.float32, seed, 0.3)
        part = ha.pair_bias_attention_plain(q[..., cols], k[..., cols], v[..., cols],
                                            bias[:, h0:], H - h0, torch.float32, seed, 0.3,
                                            (h0, H))
        same = ha.pair_bias_attention_plain(q, k, v, bias, H, torch.float32, seed, 0.3, (0, H))
        torch.testing.assert_close(part[0], whole[0][..., cols], atol=1e-6, rtol=0)
        torch.testing.assert_close(part[1], whole[1][:, h0:], atol=0, rtol=0)
        gw = ha.pair_bias_attention_bwd_plain(q, k, v, whole[1], g, None, H, seed, 0.3)
        gp = ha.pair_bias_attention_bwd_plain(q[..., cols], k[..., cols], v[..., cols],
                                              part[1], g[..., cols], None, H - h0, seed, 0.3,
                                              (h0, H))
        torch.testing.assert_close(gp[0], gw[0][..., cols], atol=1e-6, rtol=0)
        torch.testing.assert_close(gp[3], gw[3][:, h0:], atol=1e-6, rtol=0)
    else:
        mask = torch.zeros(B, N)
        mask[:, -3:] = -10000.0
        whole = ha.masked_attention_plain(q, k, v, mask, H, seed, 0.3)
        part = ha.masked_attention_plain(q[..., cols], k[..., cols], v[..., cols], mask, H - h0,
                                         seed, 0.3, (h0, H))
        same = ha.masked_attention_plain(q, k, v, mask, H, seed, 0.3, (0, H))
        torch.testing.assert_close(part[0], whole[0][..., cols], atol=1e-6, rtol=0)
        gw = ha.masked_attention_bwd_plain(q, k, v, mask, g, H, seed, 0.3)
        gp = ha.masked_attention_bwd_plain(q[..., cols], k[..., cols], v[..., cols], mask,
                                           g[..., cols], H - h0, seed, 0.3, (h0, H))
        torch.testing.assert_close(gp[1], gw[1][..., cols], atol=1e-6, rtol=0)
    for a, b in zip(same, whole):
        assert torch.equal(a, b)
    # the span matters: the first heads' masks are other masks
    assert not torch.equal(ha.keep_mask_for(seed, 0.3, B, H - h0, N, N, None, (h0, H)),
                           ha.keep_mask_for(seed, 0.3, B, H - h0, N, N, None, (0, H)))
