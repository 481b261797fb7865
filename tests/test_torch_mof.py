"""mmdti_tpu_torch's MOF path on the CPU against the JAX package, on the
same inputs:

* ``parse_cif`` and ``MOFReader`` features exactly equal to the JAX
  built-in reader's (fractional and cartesian sites, uncertainties,
  columns out of order), the crop past ``max_atoms`` included, and the
  crop independent of read order;
* GasModel, EnvModel and MOFModel from the same flax weights: forward
  within 1e-5, gradients within 1e-4, on host pair arrays and on
  coordinates (device pair mode);
* ``using_infonce`` refused and missing gas inputs raising, as
  tests/test_mof_e2e.py holds the JAX package;
* ``MolTrain(data_type='mof').fit`` -> ``MolPredict`` on the synthetic CIF
  CSVs of tests/test_mof_e2e.py equal to the JAX package's (1e-5 / 1e-4,
  tests/torch_task_parity.py), the port starting from the JAX initial
  weights; each package's MolPredict on the other's experiment dir; and
  the port's fit in device pair mode against its host-mode fit.

torch runs on one thread.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mmdti_tpu.chem import mof as jax_mof
from mmdti_tpu.models.mof import EnvModel as JaxEnv
from mmdti_tpu.models.mof import GasModel as JaxGas
from mmdti_tpu.models.mof import build_mof_model as jax_build_mof
from mmdti_tpu_torch.chem import mof
from mmdti_tpu_torch.models.convert import flax_params_to_state_dict, state_dict_to_flax_params
from mmdti_tpu_torch.models.mof import EnvModel, GasModel, build_mof_model
from tests.conftest import SMALL_ARCH
from tests.test_mof_e2e import _write_cif
from tests.test_torch_fit import jax_parity_patches
from tests.torch_task_parity import PRED_ATOL, PRED_RTOL, one_thread

MOF_ARCH = dict(unimol_overrides=dict(SMALL_ARCH["unimol_overrides"]),
                compute_dtype="float32", use_pallas=False)
FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    threads = one_thread()
    yield
    torch.set_num_threads(threads)


# ---- CIF reading and featurization -------------------------------------------

_CART_CIF = """data_cart
_cell_length_a 10.0(2)
_cell_length_b 11.5
_cell_length_c 9.25
_cell_angle_alpha 80.0
_cell_angle_beta 95.5
_cell_angle_gamma 100.25
loop_
_symmetry_equiv_pos_as_xyz
x,y,z
loop_
_atom_site_label
_atom_site_occupancy
_atom_site_Cartn_z
_atom_site_Cartn_x
_atom_site_Cartn_y
Zn1 1.0 0.5(1) 1.25 2.5
O2 1.0 3.25 0.75 1.0
C3 0.5 -1.5 2.0 4.125
Cu4+ 1.0 0.0 0.0 0.0
"""


def _assert_feats_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_parse_cif_equals_jax(tmp_path):
    paths = [_write_cif(str(tmp_path / f"m{i}.cif"), seed=i, n_atoms=7 + i) for i in range(3)]
    cart = tmp_path / "cart.cif"
    cart.write_text(_CART_CIF)
    for path in [*paths, str(cart)]:
        ours, theirs = mof.parse_cif(path), jax_mof.parse_cif(path)
        assert set(ours) == set(theirs)
        for k in ours:
            if isinstance(ours[k], np.ndarray):
                assert ours[k].dtype == theirs[k].dtype, k
                np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
            else:
                assert ours[k] == theirs[k], k
    assert mof.parse_cif(str(cart))["atoms"] == ["Zn", "O", "C", "Cu"]
    empty = tmp_path / "empty.cif"
    empty.write_text("data_x\n_cell_length_a 5\n")
    for parse in (mof.parse_cif, jax_mof.parse_cif):
        with pytest.raises(ValueError, match="no atom sites"):
            parse(str(empty))


def test_tables_equal_jax():
    assert mof.GAS_LIST == jax_mof.GAS_LIST
    assert mof.GAS2ID == jax_mof.GAS2ID
    assert mof.GAS2ATTR == jax_mof.GAS2ATTR


@pytest.fixture
def jax_builtin_reader(monkeypatch):
    """The JAX MOFReader on its built-in parser, the port's only one."""
    monkeypatch.setattr(jax_mof, "_HAVE_PYMATGEN", False)


@pytest.mark.parametrize("n_atoms,max_atoms", [(9, 512), (40, 16)], ids=["whole", "cropped"])
def test_reader_features_equal_jax(tmp_path, jax_builtin_reader, n_atoms, max_atoms):
    path = _write_cif(str(tmp_path / "x.cif"), seed=3, n_atoms=n_atoms)
    for gas in ("CO2", "H2"):
        ours = mof.MOFReader(max_atoms=max_atoms, seed=42).read_with_gas(path, gas)
        theirs = jax_mof.MOFReader(max_atoms=max_atoms, seed=42).read_with_gas(path, gas)
        _assert_feats_equal(ours, theirs)
    assert len(ours["src_tokens"]) == min(n_atoms, max_atoms) + 2
    with pytest.raises(AssertionError, match="not in list"):
        mof.MOFReader().gas_parser("Ne")


def test_crop_independent_of_read_order(tmp_path):
    big = _write_cif(str(tmp_path / "big.cif"), seed=0, n_atoms=40)
    small = _write_cif(str(tmp_path / "small.cif"), seed=1, n_atoms=6)
    first = mof.MOFReader(max_atoms=16, seed=42).read_with_gas(big, "CO2")
    r2 = mof.MOFReader(max_atoms=16, seed=42)
    r2.read_with_gas(small, "CH4")
    _assert_feats_equal(first, r2.read_with_gas(big, "CO2"))
    other = mof.MOFReader(max_atoms=16, seed=7).read_with_gas(big, "CO2")
    assert not np.array_equal(first["src_coord"], other["src_coord"])


# ---- modules from the same flax weights ------------------------------------------

def _rand_tree(tree, rng):
    """Every leaf redrawn, so no weight sits at its zero or unit init."""
    return jax.tree.map(lambda x: (rng.randn(*np.shape(x)) * 0.3).astype(np.float32), tree)


def _grads_close(model, want):
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("env_min_max", [None, {"pressure": (0.0, 10.0),
                                                "temperature": (250.0, 400.0)}],
                         ids=["default_range", "wide_range"])
def test_gas_and_env_models_match_flax(env_min_max):
    rng = np.random.RandomState(0)
    gas_id = np.array([1, 2, 9, 0], np.int32)
    gas_attr = rng.randn(4, 6).astype(np.float32)
    # inside and outside both ranges: the clip and the top bin
    pressure = np.array([0.2, 5.0, -1.0, 10.0], np.float32)
    temperature = np.array([0.5, 298.0, 260.0, 420.0], np.float32)
    cases = [
        (JaxGas(), GasModel(), (gas_id, gas_attr)),
        (JaxEnv(min_max_key=env_min_max), EnvModel(min_max_key=env_min_max),
         (pressure, temperature)),
    ]
    for jmod, tmod, args in cases:
        params = _rand_tree(jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args))["params"],
                            rng)
        want, vjp = jax.vjp(lambda p: jmod.apply({"params": p}, *map(jnp.asarray, args)),
                            params)
        cot = rng.randn(*want.shape).astype(np.float32)
        tmod.load_state_dict(flax_params_to_state_dict(params), strict=True)
        got = tmod(*map(torch.from_numpy, args))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)
        (got * torch.from_numpy(cot)).sum().backward()
        _grads_close(tmod, flax_params_to_state_dict(vjp(jnp.asarray(cot))[0]))


V, PAD = 35, 1
B, N = 3, 14


def _mof_inputs():
    """Collator-shaped MOF arrays: crystals of 12, 8 and 5 atoms (+ BOS and
    EOS), pad rows zero, the host pair arrays of coords2unimol_mof."""
    from mmdti_tpu.chem.dictionary import Dictionary

    d = Dictionary.load(None)
    d.add_symbol("[MASK]", is_special=True)
    rng = np.random.RandomState(1)
    samples = []
    for n in (12, 8, 5):
        s = jax_mof.coords2unimol_mof(rng.choice(["C", "O", "Zn", "H", "N"], n),
                                      rng.randn(n, 3).astype(np.float32) * 3.0, d)
        samples.append(s)
    from mmdti_tpu.utils.padding import pad_1d_tokens, pad_2d, pad_coords

    arrays = {
        "src_tokens": pad_1d_tokens([s["src_tokens"].astype(np.int32) for s in samples], PAD,
                                    pad_to_length=N),
        "src_distance": pad_2d([s["src_distance"] for s in samples], 0.0, pad_to_length=N),
        "src_edge_type": pad_2d([s["src_edge_type"].astype(np.int32) for s in samples], PAD,
                                pad_to_length=N),
        "src_coord": pad_coords([s["src_coord"] for s in samples], 0.0, pad_to_length=N),
        "gas_id": np.array([2, 1, 8], np.int32),
        "gas_attr": rng.randn(B, 6).astype(np.float32),
        "pressure": np.array([0.3, 0.9, 4.0], np.float32),
        "temperature": np.array([0.1, 0.7, 298.0], np.float32),
    }
    return len(d), arrays


@pytest.fixture(scope="module")
def mof_flax():
    vocab, arrays = _mof_inputs()
    model = jax_build_mof(output_dim=2, atom_vocab_size=vocab, atom_pad_idx=PAD,
                          task="regression", **MOF_ARCH)
    host = {k: jnp.asarray(v) for k, v in arrays.items() if k != "src_coord"}
    params = jax.tree.map(np.array, jax.jit(model.init)(jax.random.PRNGKey(0), **host)["params"])
    rng = np.random.RandomState(4)
    params["gbf"]["mul"] = rng.uniform(0.5, 1.5, params["gbf"]["mul"].shape).astype(np.float32)
    params["gbf"]["bias"] = rng.uniform(-0.5, 0.5, params["gbf"]["bias"].shape).astype(
        np.float32)
    for mod in ("gas_model", "env_model", "fusion_proj"):
        params[mod] = _rand_tree(params[mod], rng)
    return vocab, arrays, model, params


_Y = np.random.RandomState(2).randn(B, 2).astype(np.float32)


def _mode_feats(arrays, mode):
    drop = ("src_coord",) if mode == "host" else ("src_distance", "src_edge_type")
    return {k: v for k, v in arrays.items() if k not in drop}


@pytest.fixture(scope="module")
def mof_flax_grads(mof_flax):
    """The JAX model's MSE loss, outputs and gradients in each pair mode."""
    _, arrays, jmodel, params = mof_flax

    def jax_loss(p, feats):
        out = jmodel.apply({"params": p}, **feats)
        return jnp.mean((out["logits"] - _Y) ** 2), out

    fn = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    return {mode: fn(params, {k: jnp.asarray(v) for k, v in _mode_feats(arrays, mode).items()})
            for mode in ("host", "device")}


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernel_path"])
def test_mof_model_matches_flax(mof_flax, mof_flax_grads, mode, use_kernels):
    vocab, arrays, _, params = mof_flax
    feats = _mode_feats(arrays, mode)
    y = _Y
    (loss, want), grads = mof_flax_grads[mode]
    model = build_mof_model(2, vocab, PAD, "regression", compute_dtype="float32",
                            use_kernels=use_kernels,
                            unimol_overrides=MOF_ARCH["unimol_overrides"])
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    out = model(**{k: torch.from_numpy(v) for k, v in feats.items()})
    for key in ("logits", "pooled", "encoder_rep", "cls_repr", "pair_logits", "x_norm"):
        np.testing.assert_allclose(out[key].detach().float().numpy(), np.asarray(want[key]),
                                   atol=FWD_ATOL if key != "pair_logits" else 1e-4, rtol=0,
                                   err_msg=key)
    assert float(out["infonce_loss"]) == 0.0
    ours = torch.mean((out["logits"] - torch.from_numpy(y)) ** 2)
    np.testing.assert_allclose(float(ours.detach()), float(loss), atol=FWD_ATOL)
    ours.backward()
    _grads_close(model, flax_params_to_state_dict(grads))


def test_mof_state_dict_round_trips_to_flax(mof_flax):
    vocab, _, _, params = mof_flax
    model = build_mof_model(2, vocab, PAD, "regression",
                            unimol_overrides=MOF_ARCH["unimol_overrides"])
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    back = state_dict_to_flax_params(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_missing_gas_inputs_raise(mof_flax):
    vocab, arrays, _, _ = mof_flax
    model = build_mof_model(1, vocab, PAD, "regression",
                            unimol_overrides=MOF_ARCH["unimol_overrides"])
    base = {k: torch.from_numpy(arrays[k]) for k in ("src_tokens", "src_distance",
                                                     "src_edge_type")}
    with pytest.raises(ValueError, match="gas_id"):
        model(**base)
    with pytest.raises(ValueError, match="pressure"):
        model(**base, gas_id=torch.from_numpy(arrays["gas_id"]),
              gas_attr=torch.from_numpy(arrays["gas_attr"]))


# ---- fit and predict against the JAX package ---------------------------------------

@pytest.fixture(scope="module")
def mof_csvs(tmp_path_factory):
    """The synthetic crystals and CSVs of tests/test_mof_e2e.py."""
    tmp = tmp_path_factory.mktemp("mof_port")
    rng = np.random.RandomState(0)
    gases = ["CO2", "CH4", "N2", "H2"]
    rows = []
    for i in range(16):
        _write_cif(str(tmp / f"mof_{i}.cif"), seed=i, n_atoms=8 + (i % 5))
        rows.append({"cif": f"mof_{i}.cif", "gas": gases[i % len(gases)],
                     "pressure": float(rng.rand() * 10),
                     "temperature": float(273 + rng.rand() * 100),
                     "uptake": float(rng.randn() * 2 + 5)})
    df = pd.DataFrame(rows)
    train, val = str(tmp / "train.csv"), str(tmp / "val.csv")
    df.iloc[:12].to_csv(train, index=False)
    df.iloc[12:].to_csv(val, index=False)
    return train, val, str(tmp)


def _fit_kw(exp, **extra):
    # batch 8: the JAX package rounds a batch up to its 8-way test mesh
    return dict(task="regression", data_type="mof", epochs=3, batch_size=8, metrics="mse",
                target_cols=["uptake"], save_path=exp, using_ct=True, seed=7,
                mu_dtype="float32", **MOF_ARCH, **extra)


def test_infonce_refused_for_mof(mof_csvs):
    from mmdti_tpu_torch import MolTrain

    train, val, tmp = mof_csvs
    fit = MolTrain(**_fit_kw(os.path.join(tmp, "exp_refuse"), using_infonce=True),
                   device="cpu")
    with pytest.raises(ValueError, match="mof"):
        fit.fit(train, val)


@pytest.fixture(scope="module")
def mof_fits(mof_csvs):
    from mmdti_tpu import MolPredict as JaxPredict
    from mmdti_tpu import MolTrain as JaxTrain
    from mmdti_tpu_torch import MolPredict, MolTrain

    train, val, tmp = mof_csvs
    out = {}
    with jax_parity_patches():
        for name, train_cls, dev in (("jax", JaxTrain, {}), ("port", MolTrain,
                                                             {"device": "cpu"})):
            exp = os.path.join(tmp, f"exp_{name}")
            fit = train_cls(**_fit_kw(exp), **dev).fit(train, val)
            out[name] = {"exp": exp, "cv_pred": np.asarray(fit.cv_pred)}
        # the port again in device pair mode, from the same initial weights
        exp = os.path.join(tmp, "exp_port_device")
        fit = MolTrain(**_fit_kw(exp, device_pair_feats=True), device="cpu").fit(train, val)
        out["port_device"] = {"exp": exp, "cv_pred": np.asarray(fit.cv_pred),
                              "mode": fit.model.collator.pair_feats}
    for name in ("jax", "port"):
        exp = out[name]["exp"]
        pred_dir = os.path.join(tmp, f"pred_{name}")
        out[name]["pred"] = {
            "jax": np.asarray(JaxPredict(load_model=exp).predict(val, save_path=pred_dir)),
            "port": np.asarray(MolPredict(load_model=exp, device="cpu").predict(
                val, save_path=pred_dir)),
        }
        out[name]["pred_dir"] = pred_dir
    return out


def _close(a, b, what):
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, atol=PRED_ATOL, rtol=PRED_RTOL, err_msg=what)


def test_fit_predict_matches_jax(mof_fits):
    jx, pt = mof_fits["jax"], mof_fits["port"]
    assert pt["cv_pred"].shape == (4, 1) and np.isfinite(pt["cv_pred"]).all()
    _close(pt["cv_pred"], jx["cv_pred"], "cv_pred")
    _close(pt["pred"]["port"], jx["pred"]["jax"], "predict")
    for artifact in ("config.yaml", "model_0.ckpt", "target_scaler.ss", "history_0.json"):
        assert os.path.exists(os.path.join(pt["exp"], artifact)), artifact
    assert os.path.exists(os.path.join(pt["pred_dir"], "test_metric.result"))


@pytest.mark.parametrize("reader,writer", [("jax", "port"), ("port", "jax")])
def test_each_package_reads_the_others_mof_dir(mof_fits, reader, writer):
    from mmdti_tpu.configs.config import load_yaml as jax_load_yaml

    cfg = jax_load_yaml(os.path.join(mof_fits[writer]["exp"], "config.yaml"))
    assert cfg["data_type"] == "mof"
    _close(mof_fits[writer]["pred"][reader], mof_fits[writer]["pred"][writer],
           f"{reader} predicting the {writer} dir")


def test_device_pair_mode_fit_matches_host_mode(mof_fits):
    dev = mof_fits["port_device"]
    assert dev["mode"] == "device"
    _close(dev["cv_pred"], mof_fits["port"]["cv_pred"], "device vs host pair mode")
