"""mmdti_tpu_torch serving slice on the CPU: host featurization equals the
JAX package's, MolServe.predict equals the flax model on the same weights
(atol 1e-4, fp32), and the port (serving and one train step) imports
nothing of JAX or the JAX package's host dependencies."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmdti_tpu.chem.native as jax_native
from mmdti_tpu.chem.conformer import ConformerGen as JaxConformerGen
from mmdti_tpu.chem.tokenizer import SmilesTokenizer as JaxTokenizer
from mmdti_tpu.data.batching import BatchCollator as JaxCollator
from mmdti_tpu.models.mm_model import build_model as jax_build_model
from mmdti_tpu_torch.api.serve_api import MolServe
from mmdti_tpu_torch.chem.conformer import ConformerGen
from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
from mmdti_tpu_torch.data.batching import BatchCollator
from mmdti_tpu_torch.models.convert import flax_params_to_state_dict
from tests.conftest import SMALL_ARCH, SMILES_20

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = dict(
    task="classification", compute_dtype="float32",
    unimol_overrides=SMALL_ARCH["unimol_overrides"],
    chemberta_overrides=SMALL_ARCH["chemberta_overrides"],
)


@pytest.fixture
def numpy_refine(monkeypatch):
    """The port carries only the numpy refinement; route the JAX package's
    built-in provider through the same numpy path (no C++ library)."""
    monkeypatch.setattr(jax_native, "embed_coords", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "refine_coords", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "distance_matrix", lambda *a, **k: None)


def _jax_batch(smiles):
    gen = JaxConformerGen(coord_provider="host")
    feats = gen.transform(smiles)
    for f, s in zip(feats, smiles):
        f["smile"] = s
    coll = JaxCollator(JaxTokenizer(), pad_idx=gen.dictionary.pad(), pad_mode="bucket")
    batch, _ = coll([(f, np.zeros(1, np.float32)) for f in feats])
    return gen, feats, batch


def test_host_featurization_equals_jax(numpy_refine):
    _, jax_feats, jax_batch = _jax_batch(SMILES_20)
    gen = ConformerGen()
    feats = gen.transform(SMILES_20)
    for a, b in zip(feats, jax_feats):
        assert set(a) == set(b) - {"smile"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for f, s in zip(feats, SMILES_20):
        f["smile"] = s
    coll = BatchCollator(SmilesTokenizer(), pad_idx=gen.dictionary.pad(), pad_mode="bucket")
    batch, _ = coll([(f, np.zeros(1, np.float32)) for f in feats])
    assert set(batch) == {"src_tokens", "src_distance", "src_edge_type",
                          "input_ids", "attention_mask"}
    for k in batch:
        assert batch[k].dtype == jax_batch[k].dtype, k
        np.testing.assert_array_equal(batch[k], jax_batch[k], err_msg=k)


def test_predict_matches_flax_on_same_weights(numpy_refine):
    smiles = SMILES_20[:6]
    gen, _, batch = _jax_batch(smiles)
    model = jax_build_model(
        output_dim=2, atom_vocab_size=len(gen.dictionary), atom_pad_idx=gen.dictionary.pad(),
        task="classification", smiles_vocab_size=JaxTokenizer().vocab_size,
        compute_dtype="float32", use_pallas=False,
        unimol_overrides=SMALL_ARCH["unimol_overrides"],
        chemberta_overrides=SMALL_ARCH["chemberta_overrides"],
    )
    feats = {k: jnp.asarray(batch[k]) for k in
             ("src_tokens", "src_distance", "src_edge_type", "input_ids", "attention_mask")}
    params = jax.jit(model.init)(jax.random.PRNGKey(3), **feats)["params"]
    want = np.asarray(jax.nn.softmax(
        jax.jit(model.apply)({"params": params}, **feats)["logits"], axis=-1
    )[:, 1:])

    server = MolServe(CONFIG, flax_params_to_state_dict(jax.tree.map(np.asarray, params)),
                      device="cpu", batch_buckets=(8,))
    out = server.predict(smiles)
    np.testing.assert_allclose(out["proba"], want, atol=1e-4)
    assert out["predict"].shape == (6, 1) and out["valid"].all()
    assert server.latency_stats()["count"] == 1
    # a repeated request is answered from the featurization cache, unchanged
    again = server.predict(smiles)
    assert server.cache_hits == len(smiles)
    np.testing.assert_array_equal(again["proba"], out["proba"])
    shapes = server.compiled_shapes
    server.warmup_buckets(batch_sizes=(2,), atom_buckets=(32,), smiles_buckets=(48,))
    assert server.compiled_shapes == shapes + 1


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MolServe(CONFIG, {}, device="cuda")


_BLOCKED_SCRIPT = textwrap.dedent("""
    import sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "mmdti_tpu", "pandas", "sklearn",
               "joblib", "yaml", "msgpack", "transformers", "rdkit"}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    sys.meta_path.insert(0, Block())

    import numpy as np
    import torch
    from mmdti_tpu_torch import MolServe
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.models.mm_model import build_model

    cfg = dict(task="regression", compute_dtype="float32",
               unimol_overrides=dict(encoder_layers=1, embed_dim=16, ffn_embed_dim=32,
                                     attention_heads=2),
               chemberta_overrides=dict(hidden_size=16, num_hidden_layers=1,
                                        num_attention_heads=2, intermediate_size=32),
               crossmodal_overrides=dict(num_attention_heads=2))
    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    model = build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                        unimol_overrides=cfg["unimol_overrides"],
                        chemberta_overrides=cfg["chemberta_overrides"],
                        crossmodal_overrides=cfg["crossmodal_overrides"])
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    server = MolServe(cfg, model.state_dict(), device="cpu")
    out = server.predict(["CCO", "c1ccccc1"])
    assert out["predict"].shape == (2, 1) and np.isfinite(out["predict"]).all()

    # one train step, dropout on, on the served model's weights
    from mmdti_tpu_torch.losses.zoo import mse_loss
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import build_train_step

    feats, _ = server._device_feats(server._featurize(["CCO", "c1ccccc1"]))
    opt = FusedAdam(dict(server.model.named_parameters()), 1e-4, 10)
    step = build_train_step(server.model, opt, mse_loss, "regression")
    labels = torch.zeros(feats["src_tokens"].shape[0], 1)
    metrics = step(feats, labels, None, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("PORT_ONLY_OK")
""")


def test_slice_runs_without_jax_or_host_deps():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PORT_ONLY_OK" in proc.stdout
