"""mmdti_tpu_torch's device pair features and numerical pair kernel on the
CPU against the JAX package, on the same numpy-seeded inputs:

* ``pair_feats_from_coords`` and ``mof_pair_feats_from_coords`` against the
  JAX functions and against the host collation (molecules featurized by
  the port, MOF crystals by chem/mof.py): distances within 1e-5 (the
  JAX tests' tolerance, tests/test_pair_feats.py), edge types exactly;
* ``resolve_pair_feats_mode``: the JAX spellings, 'auto' by device;
* the device-mode collation against the JAX collator's, key for key;
* MMModel logits equal between host and device mode (1e-5, plain fp32
  and the kernel path's plain versions);
* ``pair_feats=False`` features: the JAX featurizer's arrays, and a fit
  over them that switches to device mode and predicts as the host-mode
  fit does;
* NumericalEmbed against flax from the same weights: forward 1e-5,
  gradients 1e-4; and MMModel with kernel='numerical' in both modes.

torch runs on one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdti_tpu.data.batching import BatchCollator as JaxCollator
from mmdti_tpu.ops import pair_feats as jax_pf
from mmdti_tpu_torch.chem.conformer import ConformerGen
from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
from mmdti_tpu_torch.data.batching import BatchCollator
from mmdti_tpu_torch.models.convert import flax_params_to_state_dict
from mmdti_tpu_torch.ops.pair_feats import (
    mof_pair_feats_from_coords,
    pair_feats_from_coords,
    resolve_pair_feats_mode,
)
from tests.conftest import SMALL_ARCH, SMILES_20
from tests.torch_task_parity import PRED_ATOL, PRED_RTOL, one_thread

DIST_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    threads = one_thread()
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def featurized():
    gen = ConformerGen()
    feats = gen.transform(SMILES_20[:6])
    for f, s in zip(feats, SMILES_20[:6]):
        f["smile"] = s
    return gen, feats


def _collate(feats, pair_feats, pad_idx, atom_pad=48, collator=BatchCollator):
    coll = collator(SmilesTokenizer(), pad_idx=pad_idx, pad_mode="dataset", atom_pad=atom_pad,
                    smiles_pad=24, pair_feats=pair_feats)
    return coll([(f, np.zeros(1, np.float32)) for f in feats])[0]


def _mof_samples():
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.mof import coords2unimol_mof

    d = Dictionary.load(None)
    d.add_symbol("[MASK]", is_special=True)
    rng = np.random.RandomState(0)
    samples = []
    for i, n in enumerate((5, 9, 3)):
        s = coords2unimol_mof(rng.choice(["C", "O", "Zn", "H", "Cu"], n),
                              rng.randn(n, 3).astype(np.float32) * 3.0, d)
        s.update(gas_id=1 + i, gas_attr=rng.randn(6).tolist(), pressure=float(rng.rand()),
                 temperature=float(300 + i))
        samples.append(s)
    return d, samples


def _check(fn, jax_fn, batch_dev, batch_host, vocab, pad_idx):
    tok, coord = batch_dev["src_tokens"], batch_dev["src_coord"]
    dist, edge = fn(torch.from_numpy(tok), torch.from_numpy(coord), vocab, pad_idx)
    jd, je = jax_fn(jnp.asarray(tok), jnp.asarray(coord), vocab, pad_idx)
    assert dist.dtype == torch.float32 and edge.dtype == torch.int32
    np.testing.assert_array_equal(edge.numpy(), batch_host["src_edge_type"])
    np.testing.assert_array_equal(edge.numpy(), np.asarray(je))
    np.testing.assert_allclose(dist.numpy(), batch_host["src_distance"], rtol=0, atol=DIST_ATOL)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=0, atol=DIST_ATOL)


def test_molecule_reconstruction_matches_host_and_jax(featurized):
    gen, feats = featurized
    pad = gen.dictionary.pad()
    host, dev = _collate(feats, "host", pad), _collate(feats, "device", pad)
    _check(pair_feats_from_coords, jax_pf.pair_feats_from_coords, dev, host,
           len(gen.dictionary), pad)
    # pad rows and columns: distance 0 and the pad index
    dist, edge = pair_feats_from_coords(torch.from_numpy(dev["src_tokens"]),
                                        torch.from_numpy(dev["src_coord"]),
                                        len(gen.dictionary), pad)
    n = int((dev["src_tokens"][0] != pad).sum())
    assert (dist[0, n:] == 0).all() and (dist[0, :, n:] == 0).all()
    assert (edge[0, n:] == pad).all() and (edge[0, :, n:] == pad).all()


def test_mof_reconstruction_matches_host_and_jax():
    d, samples = _mof_samples()
    pad = d.pad()
    host, dev = _collate(samples, "host", pad, 16), _collate(samples, "device", pad, 16)
    _check(mof_pair_feats_from_coords, jax_pf.mof_pair_feats_from_coords, dev, host, len(d),
           pad)
    # EOS is the last real token of each row: its distances are 0
    dist, _ = mof_pair_feats_from_coords(torch.from_numpy(dev["src_tokens"]),
                                         torch.from_numpy(dev["src_coord"]), len(d), pad)
    for b, s in enumerate(samples):
        eos = len(s["src_tokens"]) - 1
        assert (dist[b, eos] == 0).all() and (dist[b, 0] == 0).all()
        assert (dist[b, 1, 2:eos] > 0).all()


@pytest.mark.parametrize("value,want", [
    ("device", "device"), ("true", "device"), ("ON", "device"), ("1", "device"),
    ("yes", "device"), (True, "device"), (1, "device"),
    ("host", "host"), ("false", "host"), ("off", "host"), ("0", "host"), ("no", "host"),
    (False, "host"), (0, "host"),
])
def test_resolve_spellings_match_jax(value, want):
    assert resolve_pair_feats_mode(value, "cpu") == want
    assert resolve_pair_feats_mode(value, "cuda") == want
    assert jax_pf.resolve_pair_feats_mode(value) == want


def test_resolve_auto_by_device():
    for auto in ("auto", None):
        assert resolve_pair_feats_mode(auto, "cpu") == "host"
        assert resolve_pair_feats_mode(auto, torch.device("cuda", 0)) == "device"
        # the JAX rule off a TPU: host
        assert jax_pf.resolve_pair_feats_mode(auto) == "host"
    for bad in ("sideways", 2.5, [1]):
        with pytest.raises(ValueError):
            resolve_pair_feats_mode(bad, "cpu")


def test_device_collation_equals_jax(featurized):
    gen, feats = featurized
    pad = gen.dictionary.pad()
    ours = _collate(feats, "device", pad)
    theirs = _collate(feats, "device", pad, collator=JaxCollator)
    assert set(ours) == set(theirs) == {"src_tokens", "src_coord", "input_ids",
                                        "attention_mask"}
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    d, samples = _mof_samples()
    ours = _collate(samples, "device", d.pad(), 16)
    theirs = _collate(samples, "device", d.pad(), 16, collator=JaxCollator)
    assert set(ours) == set(theirs) == {"src_tokens", "src_coord", "gas_id", "gas_attr",
                                        "pressure", "temperature"}
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    with pytest.raises(ValueError, match="pair_feats"):
        BatchCollator(SmilesTokenizer(), pad_idx=d.pad(), pair_feats="sideways")


def _model(kernel="gaussian", use_kernels=False, vocab=31):
    from mmdti_tpu_torch.models.mm_model import build_model

    model = build_model(1, vocab, 1, SmilesTokenizer().vocab_size, use_kernels=use_kernels,
                        unimol_overrides={**SMALL_ARCH["unimol_overrides"], "kernel": kernel},
                        chemberta_overrides=SMALL_ARCH["chemberta_overrides"])
    return model.reset_parameters_like_flax(torch.Generator().manual_seed(3)).eval()


@pytest.mark.parametrize("kernel", ["gaussian", "numerical"])
@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernel_path"])
def test_model_logits_equal_between_modes(featurized, kernel, use_kernels):
    gen, feats = featurized
    pad = gen.dictionary.pad()
    model = _model(kernel, use_kernels, len(gen.dictionary))
    with torch.no_grad():
        for name, p in model.gbf.named_parameters():   # tables away from their init
            if name in ("mul", "bias"):
                p.add_(torch.rand(p.shape, generator=torch.Generator().manual_seed(5)) * 0.5)
        logits = {}
        for mode in ("host", "device"):
            batch = _collate(feats, mode, pad)
            t = {k: torch.from_numpy(v) for k, v in batch.items() if k != "weights"}
            logits[mode] = model(**t, outputs="logits")["logits"]
    np.testing.assert_allclose(logits["device"].numpy(), logits["host"].numpy(), atol=1e-5,
                               rtol=0)


def test_model_needs_pairs_or_coords(featurized):
    gen, feats = featurized
    batch = _collate(feats, "device", gen.dictionary.pad())
    t = {k: torch.from_numpy(v) for k, v in batch.items() if k not in ("weights", "src_coord")}
    with pytest.raises(ValueError, match="src_coord"):
        _model(vocab=len(gen.dictionary))(**t)


def test_numerical_embed_matches_flax():
    from mmdti_tpu.models.gaussian import NumericalEmbed as JaxNumerical
    from mmdti_tpu_torch.models.gaussian import NumericalEmbed

    K, E = 16, 49
    rng = np.random.RandomState(0)
    dist = (rng.rand(2, 7, 7) * 6).astype(np.float32)
    edge = rng.randint(0, E, (2, 7, 7)).astype(np.int32)
    # the cotangent of a mean over the output's elements
    cot = (rng.randn(2, 7, 7, K) / (2 * 7 * 7 * K)).astype(np.float32)
    mod = JaxNumerical(kernels=K, edge_types=E, activation_fn="gelu")
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(dist), jnp.asarray(edge))["params"]
    params = jax.tree.map(np.array, params)
    params["mul"] = rng.uniform(0.5, 1.5, params["mul"].shape).astype(np.float32)
    params["bias"] = rng.uniform(-0.5, 0.5, params["bias"].shape).astype(np.float32)
    params["ln"]["scale"] = rng.uniform(0.5, 1.5, (K,)).astype(np.float32)
    params["ln"]["bias"] = rng.uniform(-0.5, 0.5, (K,)).astype(np.float32)

    def f(p):
        return mod.apply({"params": p}, jnp.asarray(dist), jnp.asarray(edge))

    want, vjp = jax.vjp(f, params)
    want_g = flax_params_to_state_dict(vjp(jnp.asarray(cot))[0])

    ours = NumericalEmbed(K, E, "gelu")
    ours.load_state_dict(flax_params_to_state_dict(params), strict=True)
    got = ours(torch.from_numpy(dist), torch.from_numpy(edge))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    (got * torch.from_numpy(cot)).sum().backward()
    for name, p in ours.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)
    # the w_edge draw: torch's kaiming fan-in (K), the flax initializer's
    # spread (E x K = 784 draws each)
    ours.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    want_std = (2.0 / K) ** 0.5
    for w in (ours.w_edge.detach().numpy(), params["w_edge"]):
        assert abs(float(w.std()) - want_std) < 0.1 * want_std


def test_pair_feats_false_features_equal_jax(featurized):
    from mmdti_tpu.chem.conformer import ConformerGen as JaxGen

    theirs = JaxGen(pair_feats=False).transform(SMILES_20[:4])
    ours = ConformerGen(pair_feats=False).transform(SMILES_20[:4])
    _, full = featurized
    for a, b, f in zip(ours, theirs, full):
        assert set(a) == set(b) == {"src_tokens", "src_coord"}
        np.testing.assert_array_equal(a["src_tokens"], b["src_tokens"])
        np.testing.assert_array_equal(a["src_coord"], f["src_coord"])
        np.testing.assert_allclose(a["src_coord"], b["src_coord"], atol=1e-6)


def test_pair_feats_false_fit_takes_device_mode(tmp_path):
    """A conformer cache made with pair_feats=False holds no host pair
    arrays and is keyed apart; the fit over it collates in device mode and
    predicts what the host-mode fit predicts (1e-5 / 1e-4)."""
    import pickle

    import pandas as pd

    from mmdti_tpu_torch import MolPredict, MolTrain

    y = np.random.RandomState(0).randn(20) * 2 + 1
    df = pd.DataFrame({"smiles": SMILES_20, "y": y})
    train, val = str(tmp_path / "train.csv"), str(tmp_path / "val.csv")
    df.iloc[:16].to_csv(train, index=False)
    df.iloc[16:].to_csv(val, index=False)
    preds, modes = {}, {}
    for pf in (True, False):
        exp = str(tmp_path / f"exp_{pf}")
        cache = str(tmp_path / f"cache_{pf}.pkl")
        fit = MolTrain(task="regression", epochs=1, batch_size=8, learning_rate=1e-3,
                       smiles_col="smiles", target_cols=["y"], save_path=exp, seed=1,
                       compute_dtype="float32", mu_dtype="float32", use_pallas=False,
                       pair_feats=pf, cache_dir_train=cache, device="cpu",
                       **SMALL_ARCH).fit(train, val)
        modes[pf] = fit.model.collator.pair_feats
        with open(cache, "rb") as f:
            cached = pickle.load(f)
        assert cached["fingerprint"]["pair_feats"] is pf
        assert ("src_distance" in cached["features"][0]) is pf
        preds[pf] = (fit.cv_pred, MolPredict(load_model=exp, device="cpu").predict(val))
    assert modes == {True: "host", False: "device"}
    for a, b in zip(preds[False], preds[True]):
        np.testing.assert_allclose(a, b, atol=PRED_ATOL, rtol=PRED_RTOL)
