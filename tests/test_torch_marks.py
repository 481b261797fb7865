"""The train step's section marks (mmdti_tpu_torch/train/profiler.py) on
the CPU, with the launcher replaced by a recorder (a mark launches nothing
on CPU tensors):

* one step of ``TrainPrograms.feed``, ``single`` and ``stacked`` on a tiny
  MM-DTI and a tiny Uni-MOF model emits exactly the marks of MARKS (no
  smiles marks for Uni-MOF), once each, in order, one ``step`` a step;
* the losses, the gradients and the parameters after the update are
  bit-equal to the same step with the marks patched out;
* under encoder remat the backward marks stay outside the checkpointed
  layers: each is emitted once, and the layers' recomputation falls
  inside the ``unimol_bwd`` section.
"""

import numpy as np
import pytest
import torch

import mmdti_tpu_torch.models.mm_model as mm_model
import mmdti_tpu_torch.models.mof as mof
import mmdti_tpu_torch.models.unimol as port_unimol
import mmdti_tpu_torch.train.steps as steps
from mmdti_tpu_torch.losses import zoo
from mmdti_tpu_torch.train import profiler
from mmdti_tpu_torch.train.optim import FusedAdam
from mmdti_tpu_torch.train.steps import Resident, TrainPrograms
from tests.conftest import SMALL_ARCH

V, PAD, SMILES_VOCAB, N, L, ROWS, B = 12, 1, 30, 12, 10, 8, 4
DROPOUTS = {"dropout": 0.1, "emb_dropout": 0.1, "attention_dropout": 0.1,
            "activation_dropout": 0.1}
MMDTI = profiler.MARKS
UNIMOF = tuple(m for m in MMDTI if "smiles" not in m)


def _model(kind, remat=False):
    unimol = {**SMALL_ARCH["unimol_overrides"], **DROPOUTS, "remat": remat}
    if kind == "mof":
        model = mof.build_mof_model(1, V, PAD, "regression", compute_dtype="float32",
                                    use_kernels=True, unimol_overrides=unimol)
    else:
        model = mm_model.build_model(
            output_dim=1, atom_vocab_size=V, atom_pad_idx=PAD, smiles_vocab_size=SMILES_VOCAB,
            compute_dtype="float32", use_kernels=True, unimol_overrides=unimol,
            chemberta_overrides=dict(SMALL_ARCH["chemberta_overrides"],
                                     max_position_embeddings=L + 4))
    return model.reset_parameters_like_flax(torch.Generator().manual_seed(0))


def _resident(kind):
    rng = np.random.RandomState(5)
    tokens = np.full((ROWS, N), PAD, np.int64)
    for r in range(ROWS):
        n = rng.randint(4, N + 1)
        tokens[r, :n] = rng.randint(4, V, size=n)
        tokens[r, 0], tokens[r, n - 1] = 0, 2
    feats = {"src_tokens": tokens, "src_coord": rng.randn(ROWS, N, 3).astype(np.float32)}
    if kind == "mof":
        feats.update(gas_id=rng.randint(0, 9, ROWS),
                     gas_attr=rng.randn(ROWS, 6).astype(np.float32),
                     pressure=rng.uniform(0, 1, ROWS).astype(np.float32),
                     temperature=rng.uniform(0, 1, ROWS).astype(np.float32))
    else:
        ids = np.ones((ROWS, L), np.int64)
        mask = np.zeros((ROWS, L), np.int64)
        for r in range(ROWS):
            n = rng.randint(3, L + 1)
            ids[r, :n] = rng.randint(5, SMILES_VOCAB, size=n)
            ids[r, 0], ids[r, n - 1] = 0, 2
            mask[r, :n] = 1
        feats.update(input_ids=ids, attention_mask=mask)
    labels = (rng.randn(ROWS, 1) * 0.2).astype(np.float32)
    return Resident({k: torch.from_numpy(v) for k, v in feats.items()},
                    torch.from_numpy(labels), None)


def _programs(model, kind):
    opt = FusedAdam(dict(model.named_parameters()), 1e-3, 10)
    grads = {}
    real_apply = opt.apply

    def apply(g):
        grads.update({k: v.clone() for k, v in g.items() if v is not None})
        return real_apply(g)

    opt.apply = apply
    progs = TrainPrograms(model, opt, zoo.mse_loss, "regression",
                          torch.Generator().manual_seed(3), use_infonce=kind == "mmdti",
                          use_ct=True, use_weight=False)
    return progs, grads


@pytest.fixture
def launched(monkeypatch):
    """The marks launched, by name, whatever the device."""
    names = []
    monkeypatch.setattr(profiler, "_launch", lambda name, device: names.append(name))
    return names


def _run(variant, progs, res, k):
    idx = torch.arange(k * B).view(k, B)
    if variant == "feed":
        return progs.feed(res, idx)
    if variant == "single":
        return torch.stack([progs.single(*res.take(idx[j])) for j in range(k)])
    taken = [res.take(idx[j]) for j in range(k)]
    return progs.stacked({n: torch.stack([t[0][n] for t in taken]) for n in taken[0][0]},
                         torch.stack([t[1] for t in taken]))


@pytest.mark.parametrize("variant", ["feed", "single", "stacked"])
@pytest.mark.parametrize("kind", ["mmdti", "mof"])
def test_a_step_emits_the_mark_sequence(kind, variant, launched):
    progs, _ = _programs(_model(kind), kind)
    _run(variant, progs, _resident(kind), 2)
    assert launched == list(MMDTI if kind == "mmdti" else UNIMOF) * 2


@pytest.mark.parametrize("kind", ["mmdti", "mof"])
def test_marks_leave_the_step_bit_equal(kind, launched, monkeypatch):
    def step():
        model = _model(kind)
        progs, grads = _programs(model, kind)
        metrics = progs.feed(_resident(kind), torch.arange(B).view(1, B))
        return metrics, grads, {k: v.detach().clone() for k, v in model.state_dict().items()}

    marked = step()
    assert launched == list(MMDTI if kind == "mmdti" else UNIMOF)
    for module in (mm_model, mof, steps):
        monkeypatch.setattr(module, "mark", lambda name, like: None)
    for module in (mm_model, mof):
        monkeypatch.setattr(module, "mark_backward", lambda x, name: x)
    launched.clear()
    plain = step()
    assert launched == []
    assert torch.equal(marked[0], plain[0])
    assert marked[1].keys() == plain[1].keys() and len(plain[1]) > 0
    for k in plain[1]:
        assert torch.equal(marked[1][k], plain[1][k]), k
    for k in plain[2]:
        assert torch.equal(marked[2][k], plain[2][k]), k


def test_remat_marks_the_backward_once_outside_the_checkpoint(launched, monkeypatch):
    real = port_unimol.pair_bias_attention

    def counted(*args, **kwargs):
        launched.append("pair_bias")
        return real(*args, **kwargs)

    monkeypatch.setattr(port_unimol, "pair_bias_attention", counted)
    progs, _ = _programs(_model("mmdti", remat=True), "mmdti")
    progs.feed(_resident("mmdti"), torch.arange(B).view(1, B))
    layers = ["pair_bias"] * SMALL_ARCH["unimol_overrides"]["encoder_layers"]
    assert launched == ["step", "unimol", *layers, "smiles", "head", "head_bwd", "smiles_bwd",
                        "unimol_bwd", *layers, "optimizer", "end"]
