"""The docking model (mmdti_tpu_torch/models/docking.py) against the
benchmark's plain reference (h100_bench/reference/docking.py) on the CPU,
at a small size (2 + 2 encoder layers, a 2-layer decoder recycled 3 times,
E=64, 8 heads, Nm=16, Np=40) on seeded random weights, in float32:

* predictions, the loss and every parameter's gradient, with dropout off
  and with dropout on from the same draws;
* recycling: 1 round differs from 3, and each matches the reference's;
* predictions at real pairs do not move when the ligand's or the pocket's
  padding grows;
* the loss's masks (cross targets not 0 and under 8 Angstrom, holo
  targets not 0) against a hand count and the reference's boolean
  indexing;
* the pocket crop and the distance targets (chem/pocket.py);
* a docking step through TrainPrograms.feed emits DOCKING_MARKS in order;
* the memory rule's docking branch;
* MolTrain(data_type="docking").fit for one epoch on 6 complexes, then
  MolPredict's per-complex distance matrices.
"""

import os

import numpy as np
import pytest
import torch

from h100_bench.reference import docking as rd
from h100_bench.reference.model import Draws
from mmdti_tpu_torch.chem import pocket as chem_pocket
from mmdti_tpu_torch.losses import zoo
from mmdti_tpu_torch.models.docking import build_docking_model
from mmdti_tpu_torch.train import profiler
from mmdti_tpu_torch.train.nnmodel import auto_remat
from mmdti_tpu_torch.train.optim import FusedAdam
from mmdti_tpu_torch.train.steps import Resident, TrainPrograms

V = ["[CLS]", "[PAD]", "[SEP]", "[UNK]", "C", "N", "O", "S", "H", "Cl", "F", "[MASK]"]
PV = ["[CLS]", "[PAD]", "[SEP]", "[UNK]", "C", "N", "O", "S", "H", "[MASK]"]
NM, NP, B = 16, 40, 2


def _cfg(drop=0.0, recycling=3):
    u = dict(encoder_layers=2, embed_dim=64, ffn_embed_dim=128, attention_heads=8,
             dropout=drop, emb_dropout=drop, attention_dropout=drop, activation_dropout=0.0,
             activation_fn="gelu_tanh", gaussian_kernels=16, pair_dtype="float32")
    return {"atom_vocab": V, "atom_pad_idx": 1, "pocket_vocab": PV, "pocket_pad_idx": 1,
            "unimol": u, "pocket": dict(u), "decoder": {"encoder_layers": 2},
            "recycling": recycling, "dist_threshold": 8.0}


def _model(cfg, weights):
    m = build_docking_model(len(V), 1, len(PV), 1, "float32", True, cfg["unimol"],
                            cfg["pocket"], cfg["decoder"]["encoder_layers"], cfg["recycling"])
    m.load_state_dict(weights, strict=True)
    return m


def _weights(cfg, seed=1):
    return rd.make_weights(cfg, torch.Generator().manual_seed(seed))


def _complexes(rows=B, nm=NM, np_=NP, seed=0):
    """Ligand and pocket tokens and coordinates, and the [rows, nm, np_ +
    nm] targets, of random complexes that fit nm - 2 and np_ - 2 atoms."""
    rng = np.random.RandomState(seed)
    lt, pt = np.ones((rows, nm), np.int64), np.ones((rows, np_), np.int64)
    lc, pc = np.zeros((rows, nm, 3), np.float32), np.zeros((rows, np_, 3), np.float32)
    lab = np.zeros((rows, nm, np_ + nm), np.float32)
    for b in range(rows):
        n, p = rng.randint(5, min(nm, 15) - 1), rng.randint(10, min(np_, 39) - 1)
        lt[b, 0], lt[b, 1:n + 1], lt[b, n + 1] = 0, rng.randint(4, 11, n), 2
        pt[b, 0], pt[b, 1:p + 1], pt[b, p + 1] = 0, rng.randint(4, 9, p), 2
        pocket, holo = rng.randn(p, 3) * 5, rng.randn(n, 3) * 2
        conf = holo + rng.randn(n, 3)
        lc[b, 1:n + 1] = conf - conf.mean(0)
        pc[b, 1:p + 1] = pocket - pocket.mean(0)
        lab[b, 1:n + 1, 1:p + 1] = np.linalg.norm(holo[:, None] - pocket[None], axis=-1)
        lab[b, 1:n + 1, np_ + 1:np_ + n + 1] = np.linalg.norm(holo[:, None] - holo[None], axis=-1)
    t = torch.from_numpy
    return ({"src_tokens": t(lt), "src_coord": t(lc), "pocket_src_tokens": t(pt),
             "pocket_src_coord": t(pc)}, t(lab))


def _program(cfg, weights, feats, labels, seed=None):
    m = _model(cfg, weights)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    out = m(**feats, outputs="all", deterministic=seed is None, generator=gen)
    loss = zoo.docking_pose_loss(out["logits"], labels)
    names = [n for n, _ in m.named_parameters()]
    grads = torch.autograd.grad(loss, list(m.parameters()))
    return out, loss, dict(zip(names, grads))


def _reference(cfg, weights, feats, labels, seed=None):
    ref = rd.DockingReference(cfg)
    P = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    draws = Draws(None if seed is None else torch.Generator().manual_seed(seed))
    cross, holo = ref.forward(P, feats, draws)
    Np = cross.shape[-1]
    loss = rd.docking_loss(cross, holo, labels[..., :Np], labels[..., Np:], 8.0)
    grads = torch.autograd.grad(loss, list(P.values()))
    return cross, holo, loss, dict(zip(P, grads))


@pytest.mark.parametrize("dropout_seed", [None, 7], ids=["no_dropout", "dropout"])
def test_program_matches_the_reference(dropout_seed):
    cfg = _cfg(0.0 if dropout_seed is None else 0.1)
    w = _weights(cfg)
    feats, labels = _complexes()
    out, loss, grads = _program(cfg, w, feats, labels, dropout_seed)
    cross, holo, ref_loss, ref_grads = _reference(cfg, w, feats, labels, dropout_seed)
    assert torch.allclose(out["cross_distance"].detach(), cross.detach(), rtol=0, atol=1e-5)
    assert torch.allclose(out["holo_distance"].detach(), holo.detach(), rtol=0, atol=1e-5)
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    assert abs(loss - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        r = ref_grads[name]
        assert float((g - r).abs().max()) <= 1e-4 * max(1.0, float(r.abs().max())), name
        assert float(r.abs().max()) > 0, name


def test_recycling_rounds_change_the_prediction():
    feats, labels = _complexes()
    preds = {}
    for rounds in (1, 3):
        cfg = _cfg(recycling=rounds)
        w = _weights(cfg)
        out, _, _ = _program(cfg, w, feats, labels)
        cross, holo, _, _ = _reference(cfg, w, feats, labels)
        assert torch.allclose(out["cross_distance"].detach(), cross.detach(), atol=1e-5)
        assert torch.allclose(out["holo_distance"].detach(), holo.detach(), atol=1e-5)
        preds[rounds] = out["logits"].detach()
    assert float((preds[1] - preds[3]).abs().max()) > 1e-3


@pytest.mark.parametrize("grow", [(8, 0), (0, 16), (8, 16)], ids=["ligand", "pocket", "both"])
def test_padding_leaves_real_pairs_unchanged(grow):
    cfg = _cfg()
    w = _weights(cfg)
    feats, labels = _complexes()
    m = _model(cfg, w)
    base = m(**feats)
    dm, dp = grow
    wide = {"src_tokens": torch.nn.functional.pad(feats["src_tokens"], (0, dm), value=1),
            "src_coord": torch.nn.functional.pad(feats["src_coord"], (0, 0, 0, dm)),
            "pocket_src_tokens": torch.nn.functional.pad(feats["pocket_src_tokens"], (0, dp),
                                                         value=1),
            "pocket_src_coord": torch.nn.functional.pad(feats["pocket_src_coord"],
                                                        (0, 0, 0, dp))}
    out = m(**wide)
    for b in range(B):
        n = int((feats["src_tokens"][b] != 1).sum())
        p = int((feats["pocket_src_tokens"][b] != 1).sum())
        assert torch.allclose(out["cross_distance"][b, :n, :p],
                              base["cross_distance"][b, :n, :p], atol=1e-5)
        assert torch.allclose(out["holo_distance"][b, :n, :n],
                              base["holo_distance"][b, :n, :n], atol=1e-5)


def test_loss_masks_keep_the_published_entries():
    Nm, Np = 3, 4
    target = torch.zeros(1, Nm, Np + Nm)
    target[0, 1, 1:3] = torch.tensor([2.0, 9.0])            # one under 8, one past it
    target[0, 2, 1] = 7.9
    target[0, 1, Np + 2] = target[0, 2, Np + 1] = 1.5        # holo pair, both ways
    pred = torch.full_like(target, 3.0)
    cross, holo = zoo.docking_terms(pred, target)
    assert float(cross) == pytest.approx(((3 - 2.0) ** 2 + (3 - 7.9) ** 2) / 2)
    assert float(holo) == pytest.approx(3.0 - 1.5 - 0.5)     # |d| >= 1: d - beta / 2
    ref = rd.docking_loss(pred[..., :Np], pred[..., Np:], target[..., :Np], target[..., Np:], 8.0)
    assert float(zoo.docking_pose_loss(pred, target)) == pytest.approx(float(ref))
    near = torch.where(target != 0, target + 0.5, target)    # |d| < 1: d^2 / 2
    _, holo = zoo.docking_terms(near, target)
    assert float(holo) == pytest.approx(0.125)


def test_pocket_crop_and_targets():
    rng = np.random.RandomState(3)
    coords = rng.randn(30, 3).astype(np.float32) * 4
    atoms = rng.choice(["C", "N", "O", "S", "Se"], 30)
    d = chem_pocket.pocket_dictionary()
    assert [d[i] for i in range(len(d))] == PV
    f = chem_pocket.pocket_features(atoms, coords, d, max_atoms=20)
    dist = np.linalg.norm(coords - coords.mean(0), axis=1)
    keep = np.sort(np.argsort(dist)[:20])
    np.testing.assert_array_equal(f["pocket_coord"], coords[keep])
    want = [d.bos()] + [d.index(a) for a in atoms[keep]] + [d.eos()]
    np.testing.assert_array_equal(f["pocket_src_tokens"], want)
    assert d.unk() in want if "Se" in atoms[keep] else True
    np.testing.assert_allclose(f["pocket_src_coord"][1:-1].mean(0), 0, atol=1e-5)
    assert not f["pocket_src_coord"][[0, -1]].any()
    holo = rng.randn(5, 3)
    t = chem_pocket.docking_targets(holo, f["pocket_coord"])
    assert t["cross_target"].shape == (7, 22) and t["holo_target"].shape == (7, 7)
    assert not t["cross_target"][[0, -1]].any() and not t["cross_target"][:, [0, -1]].any()
    np.testing.assert_allclose(t["cross_target"][2, 3],
                               np.linalg.norm(holo[1] - f["pocket_coord"][2]), rtol=1e-6)


def test_a_docking_step_emits_the_docking_marks(monkeypatch):
    launched = []
    monkeypatch.setattr(profiler, "_launch", lambda name, device: launched.append(name))
    cfg = _cfg(0.1)
    model = _model(cfg, _weights(cfg))
    feats, labels = _complexes(rows=4)
    opt = FusedAdam(dict(model.named_parameters()), 1e-3, 10)
    progs = TrainPrograms(model, opt, zoo.docking_pose_loss, "docking",
                          torch.Generator().manual_seed(3), use_infonce=False, use_ct=False,
                          use_weight=False)
    m = progs.feed(Resident(feats, labels, None), torch.arange(4).view(2, 2))
    assert torch.isfinite(m).all()
    assert launched == list(profiler.DOCKING_MARKS) * 2


def test_memory_rule_at_the_docking_shapes():
    u = dict(_cfg()["unimol"], encoder_layers=15, embed_dim=512, ffn_embed_dim=2048,
             attention_heads=64, gaussian_kernels=128, pair_dtype="bfloat16")
    cuda, gib = torch.device("cuda"), 2 ** 30
    kw = dict(data_type="docking", total_memory=80 * gib, pocket_pad=272)
    assert not auto_remat(u, 64, 0, 8, cuda, **kw)
    assert auto_remat(u, 64, 0, 512, cuda, **kw)
    assert not auto_remat(u, 16, 0, 8, torch.device("cpu"), data_type="docking", pocket_pad=40)
    assert auto_remat(u, 16, 0, 8, torch.device("cpu"), data_type="docking", pocket_pad=160)


def test_fit_and_predict(tmp_path):
    from mmdti_tpu_torch import MolPredict, MolTrain
    from mmdti_tpu_torch.chem.smiles import parse_smiles

    smiles = ["CCO", "c1ccccc1O", "CC(=O)N", "CCN(CC)CC", "OCC(O)CO", "CCCCCC"]
    rng = np.random.RandomState(0)
    rows, sizes = [], []
    for i, s in enumerate(smiles):
        n = sum(1 for a in parse_smiles(s).atoms if a.symbol != "H")
        p = rng.randint(20, 50)
        np.savez(tmp_path / f"c{i}.npz", pocket_atoms=rng.choice(["C", "N", "O", "S"], p),
                 pocket_coord=(rng.randn(p, 3) * 6).astype(np.float32),
                 holo_coord=(rng.randn(n, 3) * 1.5).astype(np.float32))
        rows.append(f"{s},c{i}.npz")
        sizes.append((n, min(p, 40)))
    csv = tmp_path / "train.csv"
    csv.write_text("SMILES,pocket\n" + "\n".join(rows) + "\n")
    exp = str(tmp_path / "exp")
    small = dict(unimol_overrides=dict(encoder_layers=2, embed_dim=64, ffn_embed_dim=128,
                                       attention_heads=8, gaussian_kernels=16),
                 decoder_layers=2, max_pocket_atoms=40, compute_dtype="float32")
    clf = MolTrain(data_type="docking", epochs=1, batch_size=4, save_path=exp, device="cpu",
                   **small)
    clf.fit(str(csv), str(csv))
    assert clf.cv_pred.shape == (6, 16, 48 + 16)
    assert {"model_0.ckpt", "config.yaml"} <= set(os.listdir(exp))
    out = MolPredict(load_model=exp, device="cpu").predict(str(csv),
                                                          save_path=str(tmp_path / "out"))
    assert [(o["cross_distance"].shape, o["holo_distance"].shape) for o in out] == [
        ((n, p), (n, n)) for n, p in sizes]
    for o in out:
        assert (o["cross_distance"] > 0).all()
        np.testing.assert_allclose(o["holo_distance"], o["holo_distance"].T, atol=1e-6)
    saved = np.load(tmp_path / "out" / "train.predict.0.npz")
    np.testing.assert_array_equal(saved["cross_distance_5"], out[5]["cross_distance"])
