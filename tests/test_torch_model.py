"""The whole mmdti_tpu_torch MMModel forward against the flax MMModel, on the
same weights (carried across by models/convert.py) and the same numpy
inputs.  fp32 on the CPU; tolerance atol 1e-4, as tests/test_full_oracle.py
holds the flax model to its torch oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdti_tpu.models.mm_model import build_model as jax_build_model
from mmdti_tpu_torch.models.convert import (
    flax_params_to_state_dict,
    state_dict_to_flax_params,
)
from mmdti_tpu_torch.models.mm_model import build_model
from mmdti_tpu_torch.ops import hopper_attention as ha
from mmdti_tpu_torch.ops import hopper_gbf as hg
from tests.conftest import SMALL_ARCH

ATOL = 1e-4
V, PAD = 12, 1           # atom vocab, pad index
SMILES_VOCAB = 40
B, N, L = 3, 10, 14


def _inputs(seed=7):
    """Collator-shaped arrays: padded atoms carry edge_type = pad index (not
    the token outer product) and distance 0, as data/batching.py pads."""
    rng = np.random.RandomState(seed)
    n_atoms = [10, 7, 4]
    tok = np.full((B, N), PAD, np.int32)
    dist = np.zeros((B, N, N), np.float32)
    edge = np.full((B, N, N), PAD, np.int32)
    for b, n in enumerate(n_atoms):
        t = rng.randint(4, V, size=n)
        t[0], t[-1] = 0, 2                        # BOS / EOS
        tok[b, :n] = t
        c = rng.randn(n, 3).astype(np.float32)
        dist[b, :n, :n] = np.sqrt(((c[:, None] - c[None]) ** 2).sum(-1))
        edge[b, :n, :n] = t[:, None] * V + t[None, :]
    ids = np.full((B, L), 1, np.int32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate([14, 9, 5]):
        ids[b, :n] = rng.randint(5, SMILES_VOCAB, size=n)
        ids[b, 0], ids[b, n - 1] = 0, 2
        mask[b, :n] = 1
    return dict(src_tokens=tok, src_distance=dist, src_edge_type=edge,
                input_ids=ids, attention_mask=mask)


def _build(jax_side: bool, use_kernels: bool = True):
    kw = dict(
        output_dim=2, atom_vocab_size=V, atom_pad_idx=PAD,
        smiles_vocab_size=SMILES_VOCAB, compute_dtype="float32",
        unimol_overrides={**SMALL_ARCH["unimol_overrides"], "activation_fn": "gelu_tanh"},
        chemberta_overrides=dict(SMALL_ARCH["chemberta_overrides"],
                                 max_position_embeddings=40),
    )
    if jax_side:
        return jax_build_model(task="classification", use_pallas=False, **kw)
    return build_model(use_kernels=use_kernels, **kw)


@pytest.fixture(scope="module")
def flax_setup():
    """flax params with random Gaussian tables (means, stds, per-edge-type
    mul/bias), so the token outer-product selection is exercised."""
    model = _build(jax_side=True)
    inputs = _inputs()
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 **{k: jnp.asarray(v) for k, v in inputs.items()})["params"]
    params = jax.tree.map(np.array, params)
    rng = np.random.RandomState(11)
    gbf = params["gbf"]
    gbf["mul"] = rng.uniform(0.5, 1.5, gbf["mul"].shape).astype(np.float32)
    gbf["bias"] = rng.uniform(-0.5, 0.5, gbf["bias"].shape).astype(np.float32)
    gbf["means"] = rng.uniform(0, 3, gbf["means"].shape).astype(np.float32)
    gbf["stds"] = rng.uniform(0.5, 3, gbf["stds"].shape).astype(np.float32)
    out = jax.jit(model.apply)({"params": params},
                               **{k: jnp.asarray(v) for k, v in inputs.items()})
    return params, inputs, jax.tree.map(np.asarray, out)


def _port(params, use_kernels, outputs="all"):
    model = _build(jax_side=False, use_kernels=use_kernels)
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    model.eval()
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(v) for k, v in _inputs().items()},
                    outputs=outputs)
    return {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port_outputs(flax_setup):
    """Port forward on both paths, computed once for the comparisons."""
    params, _, _ = flax_setup
    return {uk: _port(params, uk) for uk in (True, False)}


OUTPUTS = ["logits", "pooled", "encoder_rep", "bert_rep", "cls_repr", "infonce_loss",
           "x_norm", "delta_pair_repr_norm"]


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_path", "oracle_path"])
@pytest.mark.parametrize("key", OUTPUTS)
def test_forward_matches_flax(flax_setup, port_outputs, use_kernels, key):
    want = flax_setup[2]
    got = port_outputs[use_kernels]
    np.testing.assert_allclose(np.asarray(got[key], np.float32),
                               np.asarray(want[key], np.float32), atol=ATOL)


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_path", "oracle_path"])
def test_pair_logits_match_flax(flax_setup, port_outputs, use_kernels):
    want = flax_setup[2]["pair_logits"]
    got = port_outputs[use_kernels]["pair_logits"]
    assert (np.isneginf(got) == np.isneginf(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL)


def test_logits_only_skips_the_rest_and_agrees(flax_setup):
    params, _, want = flax_setup
    got = _port(params, use_kernels=True, outputs="logits")
    assert set(got) == {"logits"}
    np.testing.assert_allclose(got["logits"], want["logits"], atol=ATOL)


def test_cpu_forward_launches_no_kernel(flax_setup):
    params, _, _ = flax_setup
    counters = (ha.pair_bias_attention_cuda, ha.masked_attention_cuda,
                hg.gbf_pair_bias_cuda)
    before = [c.launches for c in counters]
    _port(params, use_kernels=True)
    assert [c.launches for c in counters] == before


def test_edge_type_gather_would_differ_at_padded_rows(flax_setup):
    """Finding: selecting the Gaussian affine by src_edge_type (pad index at
    padded rows/cols) instead of the token outer product changes
    encoder_rep at padded query rows — so the port must (and does) select
    by tokens like the JAX layer."""
    params, inputs, want = flax_setup
    model = _build(jax_side=False, use_kernels=True)
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    gbf_forward = model.gbf.forward
    model.gbf.forward = lambda d, e, tokens=None, **kw: gbf_forward(d, e, None, **kw)
    with torch.no_grad():
        out = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    pad_rows = inputs["src_tokens"] == PAD
    diff = np.abs(out["encoder_rep"].numpy() - want["encoder_rep"])[pad_rows]
    assert diff.max() > 1e-3


def test_bridge_round_trip_is_exact(flax_setup):
    params, _, _ = flax_setup
    sd = flax_params_to_state_dict(params)
    back = state_dict_to_flax_params(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # every port parameter is named by the rule (strict load, no leftovers)
    model = _build(jax_side=False)
    assert set(model.state_dict()) == set(sd)
