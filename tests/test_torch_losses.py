"""Every loss of mmdti_tpu_torch.losses (zoo, contrastive, registry) against
the JAX package's on the same numpy inputs, fp32, atol 1e-6 (value and
gradient), including NaN labels for the losses that exclude them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdti_tpu.losses import contrastive as jct
from mmdti_tpu.losses import registry as jreg
from mmdti_tpu.losses import zoo as jzoo
from mmdti_tpu_torch.losses import contrastive as tct
from mmdti_tpu_torch.losses import registry as treg
from mmdti_tpu_torch.losses import zoo as tzoo

ATOL = 1e-6
B = 12


def _data(kind, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "regression":
        return rng.randn(B, 1).astype(np.float32), rng.randn(B, 1).astype(np.float32)
    if kind == "multilabel_regression":
        y = rng.randn(B, 3).astype(np.float32)
        y[rng.rand(B, 3) < 0.3] = np.nan
        return rng.randn(B, 3).astype(np.float32), y
    if kind == "classes":
        return rng.randn(B, 4).astype(np.float32), rng.randint(0, 4, (B, 1)).astype(np.int32)
    y = (rng.rand(B, 3) < 0.5).astype(np.float32)          # multilabel, NaN holes
    y[rng.rand(B, 3) < 0.25] = np.nan
    return (2 * rng.randn(B, 3)).astype(np.float32), y


def _both(jfn, tfn, logits, target):
    """(JAX value, JAX grad, port value, port grad) w.r.t. the logits."""
    jv, jg = jax.value_and_grad(lambda x: jfn(x, jnp.asarray(target)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tv = tfn(x, torch.from_numpy(target))
    (tg,) = torch.autograd.grad(tv, x)
    return np.asarray(jv), np.asarray(jg), tv.detach().numpy(), tg.numpy()


def _assert_same(jv, jg, tv, tg):
    np.testing.assert_allclose(tv, jv, atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(tg, jg, atol=ATOL, rtol=1e-6)


ZOO_CASES = [
    ("mse_loss", "regression"),
    ("rmse_loss", "regression"),
    ("cross_entropy_loss", "classes"),
    ("bce_with_logits", "binary"),
    ("masked_bce_with_logits", "multilabel"),
    ("mae_with_nan", "multilabel_regression"),
    ("bce_with_nan", "multilabel"),
    ("focal_loss_with_logits", "multilabel"),
]


@pytest.mark.parametrize("name,kind", ZOO_CASES, ids=[c[0] for c in ZOO_CASES])
def test_zoo_loss_matches_jax(name, kind):
    logits, target = _data("multilabel" if kind == "binary" else kind)
    if kind == "binary":
        target = np.nan_to_num(target, nan=1.0)
    _assert_same(*_both(getattr(jzoo, name), getattr(tzoo, name), logits, target))
    assert getattr(getattr(tzoo, name), "nan_maskable", False) == getattr(
        getattr(jzoo, name), "nan_maskable", False)


@pytest.mark.parametrize("name", ["ghmc_loss", "ghmr_loss"])
@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "ema_state"])
def test_ghm_loss_and_bin_state_match_jax(name, with_state):
    logits, target = _data("multilabel", seed=1)
    target = np.nan_to_num(target, nan=0.0)
    if name == "ghmr_loss":
        logits, target = _data("multilabel_regression", seed=1)
        target = np.nan_to_num(target, nan=0.5)
    state = np.random.RandomState(2).rand(10).astype(np.float32) * 5 if with_state else None
    js = None if state is None else jnp.asarray(state)
    ts = None if state is None else torch.from_numpy(state)
    jv, jg, tv, tg = _both(lambda x, y: getattr(jzoo, name)(x, y, js)[0],
                           lambda x, y: getattr(tzoo, name)(x, y, ts)[0], logits, target)
    _assert_same(jv, jg, tv, tg)
    jc = getattr(jzoo, name)(jnp.asarray(logits), jnp.asarray(target), js)[1]
    tc = getattr(tzoo, name)(torch.from_numpy(logits), torch.from_numpy(target), ts)[1]
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)


def _ct_inputs(kind, seed):
    rng = np.random.RandomState(seed)
    feat = rng.randn(B, 16).astype(np.float32)
    if kind == "regression":
        y = (rng.randn(B, 1) * 0.3).astype(np.float32)
        out = (y + 0.1 * rng.randn(B, 1)).astype(np.float32)
    elif kind == "multilabel_regression":
        y = (rng.randn(B, 2) * 0.3).astype(np.float32)
        y[0] = np.nan                       # a row with no valid label
        y[3, 1] = np.nan
        out = (rng.randn(B, 2) * 0.3).astype(np.float32)
    elif kind == "classification":
        y = rng.randint(0, 2, (B, 1)).astype(np.float32)
        out = rng.randn(B, 2).astype(np.float32)
    else:
        y = rng.randint(0, 2, (B, 3)).astype(np.float32)
        out = rng.randn(B, 3).astype(np.float32)
    return feat, y, out, rng.uniform(0.5, 2.0, (B, 1)).astype(np.float32)


CT_TASKS = ["regression", "multilabel_regression", "classification", "multiclass",
            "multilabel_classification"]


@pytest.mark.parametrize("use_weight", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("task", CT_TASKS)
def test_ct_registry_loss_matches_jax(task, use_weight):
    """Value and feature gradient of each task's CT loss."""
    feat, y, out, w = _ct_inputs(task, seed=CT_TASKS.index(task))
    jfn, tfn = jct.CT_REGISTRY[task], tct.CT_REGISTRY[task]
    assert tfn.__name__ == jfn.__name__
    jw = jnp.asarray(w) if use_weight else None
    tw = torch.from_numpy(w) if use_weight else None
    jv, jg = jax.value_and_grad(
        lambda f: jfn(f, jnp.asarray(y), jnp.asarray(out), weights=jw, w=0.2))(jnp.asarray(feat))
    f = torch.from_numpy(feat).requires_grad_()
    tv = tfn(f, torch.from_numpy(y), torch.from_numpy(out), weights=tw, w=0.2)
    (tg,) = torch.autograd.grad(tv, f)
    _assert_same(np.asarray(jv), np.asarray(jg), tv.detach().numpy(), tg.numpy())


REGISTRY_KEYS = [("classification", None), ("multiclass", None), ("regression", None),
                 ("multilabel_regression", None), ("multilabel_classification", None),
                 ("multilabel_classification", "bce"), ("multilabel_classification", "ghm"),
                 ("multilabel_classification", "focal")]


@pytest.mark.parametrize("task,key", REGISTRY_KEYS)
def test_resolved_task_loss_matches_jax(task, key):
    kind = {"classification": "classes", "multiclass": "classes",
            "regression": "regression", "multilabel_regression": "multilabel_regression",
            "multilabel_classification": "multilabel"}[task]
    logits, target = _data(kind, seed=3)
    if key in ("bce", "ghm"):
        target = np.nan_to_num(target, nan=0.0)
    jfn, tfn = jreg.resolve_loss(task, key), treg.resolve_loss(task, key)
    _assert_same(*_both(jfn, tfn, logits, target))
    assert getattr(tfn, "nan_maskable", False) == getattr(jfn, "nan_maskable", False)
    assert treg.target_is_integer(task) == jreg.target_is_integer(task)
    x = np.random.RandomState(4).randn(B, 3).astype(np.float32)
    np.testing.assert_allclose(treg.ACTIVATION_REGISTRY[task](torch.from_numpy(x)).numpy(),
                               np.asarray(jreg.ACTIVATION_REGISTRY[task](jnp.asarray(x))),
                               atol=ATOL)
