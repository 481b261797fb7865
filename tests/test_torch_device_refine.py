"""The port's device conformer provider on the CPU (ops/device_refine.py,
chem/device_conformer.py, the provider rule in chem/conformer.py and the
cache fingerprint in data/hub.py) against the JAX package's.

Tolerances: ``refine_conformers`` of the two packages on the same padded
inputs agree within 1e-4 A on the SMILES of tests/test_device_refine.py
(3e-5 measured) and within 1e-3 A on a 122-atom chain (2.0e-4 measured):
XLA and PyTorch sum the spring forces and the repulsion rows in other
orders, and 300 iterations of descent carry that round-off on; inside
each package a group repeats bit for bit.  ``refine_energy`` of the two on
the same coordinates within 1e-5 relative.  The JAX package's own oracles,
ported: geometry against the float64 host refinement (0.15 A), the energy
reached (at most 1.10 x the host's), co-batching (1e-5), repeat calls
bit-equal, routing by size and by term caps.
"""

import numpy as np
import pytest
import torch

import mmdti_tpu.chem.device_conformer as jax_dc
from mmdti_tpu.chem.conformer import ConformerGen as JaxGen
from mmdti_tpu.data.hub import _featurizer_fingerprint as jax_fingerprint
from mmdti_tpu.ops.device_refine import refine_conformers as jax_refine
from mmdti_tpu.ops.device_refine import pad_counts as jax_pad
from mmdti_tpu.ops.device_refine import refine_energy as jax_energy
import mmdti_tpu_torch.chem.device_conformer as dc
from mmdti_tpu_torch.chem.conformer import (
    ConformerGen,
    _build_terms,
    _refine,
    builtin_smi2coords,
    resolve_coord_provider,
)
from mmdti_tpu_torch.chem.smiles import parse_smiles
from mmdti_tpu_torch.data.hub import _featurizer_fingerprint
from mmdti_tpu_torch.ops import device_refine
from mmdti_tpu_torch.ops.device_refine import refine_conformers, refine_energy
from tests.torch_task_parity import one_thread

SMILES = ["CCO", "c1ccccc1", "CC(=O)Oc1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"]
CHAIN = "C" * 40   # 122 atoms: bucket 128
PORT_JAX_ATOL = 1e-4
PORT_JAX_ATOL_LARGE = 1e-3
ENERGY_RTOL = 1e-5
BATCH_COMPOSITION_ATOL = 1e-5   # tests/test_device_refine.py


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    threads = one_thread()
    yield
    torch.set_num_threads(threads)


def _group(smis, m=None):
    """One bucket's padded host arrays, as DeviceConformerBatcher builds
    them (M padded further to ``m``)."""
    items = [(i, dc._prepare(s, 42)) for i, s in enumerate(smis)]
    bucket = dc._atom_bucket(max(len(it[0]) for _, it in items))
    arrays = dc.DeviceConformerBatcher(device="cpu").group_arrays(bucket, items)
    if m is not None and m > arrays[0].shape[0]:
        arrays = tuple(np.concatenate([a, np.zeros((m - a.shape[0],) + a.shape[1:], a.dtype)])
                       for a in arrays)
    return arrays, items


def _port(arrays, **kw):
    return refine_conformers(*[torch.from_numpy(a) for a in arrays], **kw).numpy()


def _mask(n_atoms, np_):
    return (np.arange(np_)[None] < n_atoms[:, None]).astype(np.float32)


def _dmat(x):
    d = x[:, None, :] - x[None, :, :]
    return np.sqrt((d * d).sum(-1))


# two JAX compiles: the four SMILES share bucket 64 (M 8), the chain 128
@pytest.mark.parametrize("smis,atol", [(SMILES, PORT_JAX_ATOL), ([CHAIN], PORT_JAX_ATOL_LARGE)])
def test_refine_and_energy_match_jax(smis, atol):
    arrays, items = _group(smis)
    ours = _port(arrays)
    theirs = np.array(jax_refine(*arrays, iters=300))
    for r, (_, item) in enumerate(items):
        n = len(item[0])
        np.testing.assert_allclose(ours[r, :n], theirs[r, :n], atol=atol, rtol=0)
    mask = _mask(arrays[1], arrays[0].shape[1])
    e_ours = refine_energy(torch.from_numpy(theirs), torch.from_numpy(mask),
                           *[torch.from_numpy(a) for a in arrays[2:]]).numpy()
    e_theirs = np.asarray(jax_energy(theirs, mask, *arrays[2:]))
    np.testing.assert_allclose(e_ours, e_theirs, rtol=ENERGY_RTOL, atol=1e-6)


def test_refine_conformers_preparation_matches_jax():
    """_prepare and the group arrays (int16 indices, force-free padding) are
    the JAX package's."""
    arrays, items = _group(SMILES[2:])
    jax_items = [(i, jax_dc._prepare(s, 42)) for i, s in enumerate(SMILES[2:])]
    for (_, a), (_, b) in zip(items, jax_items):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert arrays[2].dtype == np.int16 and arrays[0].shape[0] == device_refine.pad_counts(2)
    for n in (1, 7, 8, 9, 100, 128, 129, 200):
        assert device_refine.pad_counts(n) == jax_pad(n)
        assert dc._atom_bucket(n) == jax_dc._atom_bucket(n)


@pytest.mark.parametrize("smi", SMILES)
def test_geometry_and_energy_against_host_float64(smi):
    mol = parse_smiles(smi).add_hydrogens()
    arrays, items = _group([smi])
    n = len(items[0][1][0])
    dev = _port(arrays)[0, :n]
    coords0 = items[0][1][1]
    host = _refine(coords0.copy(), _build_terms(mol), iters=300)
    np.testing.assert_allclose(_dmat(dev), _dmat(host), atol=0.15)

    def energy(x):
        return float(refine_energy(torch.from_numpy(x[None]), torch.ones(1, n),
                                   *[torch.from_numpy(a[None]) for a in items[0][1][2:]])[0])

    e_dev, e_host, e_init = energy(dev), energy(host), energy(coords0)
    assert e_dev <= e_host * 1.10 + 1e-3, (e_dev, e_host)
    assert e_dev < e_init * 0.2, (e_dev, e_init)


def test_co_batching_and_repeats():
    alone = dc.device_smi2coords_batch(["CCO"], min_atoms=0, device="cpu")[0][1]
    pair = dc.device_smi2coords_batch(["CCO", "CCN"], min_atoms=0, device="cpu")[0][1]
    np.testing.assert_allclose(alone, pair, atol=BATCH_COMPOSITION_ATOL, rtol=0)
    again = dc.device_smi2coords_batch(["CCO"], min_atoms=0, device="cpu")[0][1]
    np.testing.assert_array_equal(alone, again)


def test_a_large_bucket_refines_in_groups_of_at_most_group_max(monkeypatch):
    """More than GROUP_MAX molecules of one atom bucket: they refine in
    groups of at most GROUP_MAX (so a group's molecule count pads to 8-64
    and the shapes stay bounded), and each molecule matches its lone
    refinement within BATCH_COMPOSITION_ATOL."""
    unique = ["CCO", "CCN", "CCC", "CO", "CCCO", "CC(C)O", "OCCO", "CC=O", "C=CC", "NCCO"]
    smis = [unique[i % len(unique)] for i in range(dc.GROUP_MAX + 6)]
    groups = []
    refine = device_refine.refine_conformers

    def spy(*tensors, **kw):
        groups.append(tuple(tensors[0].shape[:2]))
        return refine(*tensors, **kw)

    monkeypatch.setattr(device_refine, "refine_conformers", spy)
    out = dc.device_smi2coords_batch(smis, min_atoms=0, device="cpu")
    assert groups == [(dc.GROUP_MAX, 16), (8, 16)]
    alone = {s: dc.device_smi2coords_batch([s], min_atoms=0, device="cpu")[0] for s in unique}
    for smi, (atoms, coords) in zip(smis, out):
        assert atoms == alone[smi][0]
        np.testing.assert_allclose(coords, alone[smi][1], atol=BATCH_COMPOSITION_ATOL, rtol=0)


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_tf32_setting_does_not_reach_the_refinement(api):
    """Reduced-precision matmuls asked for either way: the refinement runs
    in full fp32 all the same, and the setting is as it was after it."""
    arrays, _ = _group(SMILES[:2])
    want = _port(arrays)
    mkldnn = torch.backends.mkldnn.matmul
    saved = (torch.get_float32_matmul_precision(), mkldnn.fp32_precision,
             torch.backends.cuda.matmul.fp32_precision)
    try:
        if api == "legacy":
            torch.set_float32_matmul_precision("medium")
        else:
            mkldnn.fp32_precision = "bf16"
            torch.backends.cuda.matmul.fp32_precision = "tf32"
        before = (mkldnn.fp32_precision, torch.backends.cuda.matmul.fp32_precision)
        got = _port(arrays)
        assert (mkldnn.fp32_precision, torch.backends.cuda.matmul.fp32_precision) == before
    finally:
        torch.set_float32_matmul_precision(saved[0])
        mkldnn.fp32_precision, torch.backends.cuda.matmul.fp32_precision = saved[1:]
    np.testing.assert_array_equal(got, want)


def test_conformer_gen_device_matches_jax_and_single_process():
    """Ibuprofen (bucket 64) and the chain (128), alone in their groups:
    the JAX shapes of test_refine_and_energy_match_jax, compiled once."""
    kw = dict(coord_provider="device", seed=42, device_refine_min_atoms=0)
    smis = [SMILES[3], CHAIN]
    ours = ConformerGen(device="cpu", **kw).transform(smis)
    theirs = JaxGen(**kw).transform(smis)
    for a, b, atol in zip(ours, theirs, (PORT_JAX_ATOL, PORT_JAX_ATOL_LARGE)):
        assert set(a) == set(b) == {"src_tokens", "src_distance", "src_coord", "src_edge_type"}
        np.testing.assert_array_equal(a["src_tokens"], b["src_tokens"])
        np.testing.assert_array_equal(a["src_edge_type"], b["src_edge_type"])
        np.testing.assert_allclose(a["src_coord"], b["src_coord"], atol=atol, rtol=0)
    single = ConformerGen(device="cpu", **kw).single_process(smis[0])
    np.testing.assert_allclose(single["src_coord"], ours[0]["src_coord"],
                               atol=BATCH_COMPOSITION_ATOL, rtol=0)
    np.testing.assert_array_equal(single["src_tokens"], ours[0]["src_tokens"])
    f = ours[0]
    n = len(f["src_tokens"])
    assert f["src_distance"].shape == (n, n) and f["src_coord"].shape == (n, 3)
    assert (f["src_coord"][0] == 0).all() and (f["src_coord"][-1] == 0).all()


def test_routing_by_size_and_term_caps(monkeypatch):
    out = dc.device_smi2coords_batch(["CCO", CHAIN], seed=42, min_atoms=48, device="cpu")
    h_atoms, h_coords = builtin_smi2coords("CCO", seed=42)
    assert out[0][0] == h_atoms
    np.testing.assert_array_equal(out[0][1], h_coords)       # 9 atoms: the host ladder
    assert out[1][0] == [*["C"] * 40, *["H"] * 82]
    assert not np.array_equal(out[1][1], builtin_smi2coords(CHAIN, seed=42)[1])
    monkeypatch.setattr(dc, "_NB_FACTOR", 0)                   # every molecule past the cap
    capped = dc.device_smi2coords_batch([CHAIN], seed=42, min_atoms=0, device="cpu")
    np.testing.assert_array_equal(capped[0][1], builtin_smi2coords(CHAIN, seed=42)[1])


def test_device_failure_raises_not_falls_back(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(device_refine, "refine_conformers", broken)
    with pytest.raises(RuntimeError, match="device lost"):
        dc.device_smi2coords_batch([CHAIN], min_atoms=0, device="cpu")


def test_provider_rule_and_fingerprints():
    assert resolve_coord_provider("host", "cuda") == "host"
    assert resolve_coord_provider("device", "cpu") == "device"
    assert resolve_coord_provider("auto", "cpu") == "host"
    assert resolve_coord_provider("auto", torch.device("cuda", 0)) == "device"
    with pytest.raises(ValueError, match="coord_provider"):
        ConformerGen(coord_provider="gpu")
    with pytest.raises(ValueError, match="coord_provider"):
        resolve_coord_provider("gpu")
    for params in ({}, {"coord_provider": "host"}, {"coord_provider": "device"},
                   {"coord_provider": "device", "device_refine_min_atoms": 16},
                   {"coord_provider": "auto", "remove_hs": True}):
        assert _featurizer_fingerprint({**params, "device": "cpu"}) == jax_fingerprint(params)
    on_card = _featurizer_fingerprint({"device": "cuda"})
    assert on_card == jax_fingerprint({"coord_provider": "device"})
    assert on_card != _featurizer_fingerprint({"device": "cpu"})


def test_hub_and_serving_take_the_device_provider(tmp_path):
    """coord_provider='device' featurizes through DataHub (a cache keyed
    apart from the host one) and through MolServe, where both refused it."""
    import pickle

    from mmdti_tpu_torch.api.serve_api import MolServe
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.data.hub import DataHub
    from mmdti_tpu_torch.models.mm_model import build_model

    cache = str(tmp_path / "c.pkl")
    hub = DataHub(data={"smiles": SMILES, "y": [0.0, 1.0, 2.0, 3.0]}, is_train=True,
                  task="regression", target_cols=["y"], smiles_col="smiles",
                  use_scaler=False, cache_dir_train=cache, coord_provider="device",
                  device_refine_min_atoms=0, device="cpu")
    want = ConformerGen(coord_provider="device", device="cpu",
                        device_refine_min_atoms=0).transform(SMILES)
    for a, b in zip(hub.data["unimol_input"], want):
        np.testing.assert_array_equal(a["src_coord"], b["src_coord"])
    with open(cache, "rb") as f:
        assert pickle.load(f)["fingerprint"]["coord_provider"] == "device"

    cfg = dict(task="regression", compute_dtype="float32", coord_provider="device",
               device_refine_min_atoms=0,
               unimol_overrides=dict(encoder_layers=1, embed_dim=16, ffn_embed_dim=32,
                                     attention_heads=2),
               chemberta_overrides=dict(hidden_size=16, num_hidden_layers=1,
                                        num_attention_heads=2, intermediate_size=32),
               crossmodal_overrides=dict(num_attention_heads=2))
    d = ConformerGen().dictionary
    model = build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                        unimol_overrides=cfg["unimol_overrides"],
                        chemberta_overrides=cfg["chemberta_overrides"],
                        crossmodal_overrides=cfg["crossmodal_overrides"])
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    server = MolServe.from_state_dict(cfg, model.state_dict(), device="cpu")
    assert server.conformer.resolved_provider() == "device"
    assert server.conformer.capture_gate is server._pull_gate
    out = server.predict(SMILES)
    assert out["valid"].all() and np.isfinite(out["predict"]).all()
    feats = server._featurize(SMILES)
    for a, b in zip(feats, want):
        np.testing.assert_array_equal(a["src_coord"], b["src_coord"])
