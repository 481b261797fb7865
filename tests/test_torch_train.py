"""The mmdti_tpu_torch train step against the JAX package's, on the same
weights (models/convert.py) and the same numpy batch, fp32 on the CPU with
dropout off:

* the optimizer: five steps of clip + Adam + apply from one state and the
  same gradients match make_fused_apply (atol 1e-6);
* the whole model: every parameter gradient of
  alpha*MSE + beta*InfoNCE + beta*ct_regress matches jax.grad of the flax
  XLA path (atol 1e-4, rtol 1e-3, as tests/test_full_oracle.py), on both
  the kernel path (the Hopper kernels' plain versions on CPU tensors) and
  the oracle path;
* three train steps match value_and_grad + make_fused_apply (losses atol
  1e-4, params atol 1e-5);
* the eval step's padded-row handling matches _make_batch_loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmdti_tpu.losses.contrastive import ct_regress as jax_ct_regress
from mmdti_tpu.losses.zoo import mae_with_nan as jax_mae_with_nan
from mmdti_tpu.losses.zoo import mse_loss as jax_mse
from mmdti_tpu.models.mm_model import build_model as jax_build_model
from mmdti_tpu.train.optim import make_fused_apply, make_optimizer
from mmdti_tpu.train.steps import _make_batch_loss
from mmdti_tpu_torch.losses import zoo
from mmdti_tpu_torch.models.convert import adam_state_from_optax, flax_params_to_state_dict
from mmdti_tpu_torch.models.mm_model import build_model
from mmdti_tpu_torch.train.optim import FusedAdam
from mmdti_tpu_torch.train.steps import build_eval_step, build_train_step, make_batch_loss
from tests.conftest import SMALL_ARCH

ALPHA, BETA, CT_W = 1.0, 0.1, 0.2   # train/trainer.py defaults
V, PAD, SMILES_VOCAB = 12, 1, 40
B, N, L = 4, 10, 12


def _flax_to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _opt_params():
    rng = np.random.RandomState(0)
    return {"a": {"kernel": rng.randn(6, 4).astype(np.float32),
                  "bias": rng.randn(4).astype(np.float32)},
            "b": {"scale": rng.randn(5).astype(np.float32)}}


@pytest.mark.parametrize("mu_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("frozen", [False, True], ids=["all_trained", "frozen_b"])
def test_fused_adam_matches_make_fused_apply(mu_dtype, frozen):
    """Warmup (2 steps) then decay, gradients alternating large (the clip
    triggers at max_norm 1) and small; one JAX step first, so the state
    carried across is not all zeros."""
    lr, n_steps, warmup, max_norm = 1e-2, 8, 0.25, 1.0
    params = jax.tree.map(jnp.asarray, _opt_params())
    mask = {"a": {"kernel": False, "bias": False}, "b": {"scale": True}} if frozen else None
    tx, _ = make_optimizer(lr, n_steps, warmup, max_norm, frozen_mask=mask, mu_dtype=mu_dtype)
    apply = make_fused_apply(lr, n_steps, warmup, max_norm, frozen_mask=mask,
                             mu_dtype=mu_dtype)
    state = tx.init(params)

    def grads_at(i):
        scale = 10.0 if i % 2 == 0 else 0.05
        return jax.tree.map(lambda p: scale * jnp.sin(p * (i + 1)), params)

    params, state = apply(grads_at(0), state, params)
    t_params = {k: v.clone() for k, v in flax_params_to_state_dict(_flax_to_numpy(params)).items()}
    t_dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[mu_dtype]
    opt = FusedAdam(t_params, lr, n_steps, warmup, max_norm,
                    frozen={"b.weight"} if frozen else None, mu_dtype=t_dtype)
    adam, sched = state[-1]
    opt.load_state(adam_state_from_optax(_flax_to_numpy(adam.mu), _flax_to_numpy(adam.nu),
                                         int(adam.count), int(sched.count), t_dtype))
    for i in range(1, 6):
        g = grads_at(i)
        params, state = apply(g, state, params)
        opt.apply({k: v for k, v in flax_params_to_state_dict(_flax_to_numpy(g)).items()})
    want = flax_params_to_state_dict(_flax_to_numpy(params))
    adam = state[-1][0]
    for name, val in want.items():
        torch.testing.assert_close(t_params[name], val, atol=1e-6, rtol=0)
    for got, ref in ((opt.state.mu, adam.mu), (opt.state.nu, adam.nu)):
        ref = flax_params_to_state_dict(_flax_to_numpy(ref))
        for name, val in ref.items():
            assert got[name].dtype == (t_dtype if got is opt.state.mu else torch.float32)
            torch.testing.assert_close(got[name].float(), val, atol=1e-6, rtol=0)
    assert opt.state.count == int(adam.count) == 6
    if frozen:
        torch.testing.assert_close(
            t_params["b.weight"], torch.from_numpy(_opt_params()["b"]["scale"]), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def _batch(seed=7):
    """Collator-shaped arrays: padded atoms carry the pad token, distance 0
    and edge type = pad index; labels and sample weights."""
    rng = np.random.RandomState(seed)
    tok = np.full((B, N), PAD, np.int32)
    dist = np.zeros((B, N, N), np.float32)
    edge = np.full((B, N, N), PAD, np.int32)
    for b, n in enumerate([10, 7, 4, 8]):
        t = rng.randint(4, V, size=n)
        t[0], t[-1] = 0, 2
        tok[b, :n] = t
        c = rng.randn(n, 3).astype(np.float32)
        dist[b, :n, :n] = np.sqrt(((c[:, None] - c[None]) ** 2).sum(-1))
        edge[b, :n, :n] = t[:, None] * V + t[None, :]
    ids = np.full((B, L), 1, np.int32)
    mask = np.zeros((B, L), np.int32)
    for b, n in enumerate([12, 9, 5, 7]):
        ids[b, :n] = rng.randint(5, SMILES_VOCAB, size=n)
        ids[b, 0], ids[b, n - 1] = 0, 2
        mask[b, :n] = 1
    feats = dict(src_tokens=tok, src_distance=dist, src_edge_type=edge, input_ids=ids,
                 attention_mask=mask)
    labels = (rng.randn(B, 1) * 0.2).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, (B, 1)).astype(np.float32)
    return feats, labels, weights


def _build(jax_side: bool, use_kernels: bool = True):
    kw = dict(
        output_dim=1, atom_vocab_size=V, atom_pad_idx=PAD, smiles_vocab_size=SMILES_VOCAB,
        compute_dtype="float32",
        unimol_overrides={**SMALL_ARCH["unimol_overrides"], "activation_fn": "gelu_tanh"},
        chemberta_overrides=dict(SMALL_ARCH["chemberta_overrides"], max_position_embeddings=40),
    )
    if jax_side:
        return jax_build_model(task="regression", use_pallas=False, **kw)
    return build_model(use_kernels=use_kernels, **kw)


def _jax_loss(model):
    def loss(params, feats, labels, weights):
        out = model.apply({"params": params}, **feats, deterministic=True)
        task = jax_mse(out["logits"], labels)
        ct = jax_ct_regress(out["pooled"], labels, out["logits"], weights=weights, w=CT_W)
        return ALPHA * task + BETA * out["infonce_loss"] + BETA * ct
    return loss


@pytest.fixture(scope="module")
def setup():
    """flax params (random Gaussian tables, so the token-pair selection and
    its gradient are exercised), the batch, and jax.grad at those params."""
    model = _build(jax_side=True)
    feats, labels, weights = _batch()
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), **jf)["params"]
    params = _flax_to_numpy(params)
    rng = np.random.RandomState(11)
    gbf = params["gbf"]
    gbf["mul"] = rng.uniform(0.5, 1.5, gbf["mul"].shape).astype(np.float32)
    gbf["bias"] = rng.uniform(-0.5, 0.5, gbf["bias"].shape).astype(np.float32)
    gbf["means"] = rng.uniform(0, 3, gbf["means"].shape).astype(np.float32)
    gbf["stds"] = rng.uniform(0.5, 3, gbf["stds"].shape).astype(np.float32)
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss(model)))
    loss, grads = value_and_grad(params, jf, jnp.asarray(labels), jnp.asarray(weights))
    return dict(model=model, params=params, feats=feats, labels=labels, weights=weights,
                loss=float(loss), grads=flax_params_to_state_dict(_flax_to_numpy(grads)),
                value_and_grad=value_and_grad)


def _port_model(params, use_kernels=True):
    model = _build(jax_side=False, use_kernels=use_kernels)
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return model


def _t(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


@pytest.mark.parametrize("use_kernels", [True, False], ids=["kernel_path", "oracle_path"])
def test_every_parameter_gradient_matches_jax(setup, use_kernels):
    model = _port_model(setup["params"], use_kernels)
    out = model(**_t(setup["feats"]), outputs="train")
    labels, weights = torch.from_numpy(setup["labels"]), torch.from_numpy(setup["weights"])
    from mmdti_tpu_torch.losses.contrastive import ct_regress

    loss = (ALPHA * zoo.mse_loss(out["logits"], labels) + BETA * out["infonce_loss"]
            + BETA * ct_regress(out["pooled"], labels, out["logits"], weights=weights, w=CT_W))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), setup["loss"], atol=1e-5)
    assert set(names) == set(setup["grads"])
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), setup["grads"][name].numpy(), atol=1e-4,
                                   rtol=1e-3, err_msg=name)


def test_three_train_steps_match_jax(setup):
    lr, n_steps = 1e-4, 10
    model = setup["model"]
    apply = jax.jit(make_fused_apply(lr, n_steps, 0.0, 5.0))
    tx, _ = make_optimizer(lr, n_steps, 0.0, 5.0)
    params = jax.tree.map(jnp.asarray, setup["params"])
    state = tx.init(params)
    jf = {k: jnp.asarray(v) for k, v in setup["feats"].items()}
    labels, weights = jnp.asarray(setup["labels"]), jnp.asarray(setup["weights"])

    port = _port_model(setup["params"])
    opt = FusedAdam(dict(port.named_parameters()), lr, n_steps, 0.0, 5.0)
    step = build_train_step(port, opt, zoo.mse_loss, "regression", alpha=ALPHA, beta=BETA,
                            ct_w=CT_W)
    for _ in range(3):
        loss, grads = setup["value_and_grad"](params, jf, labels, weights)
        params, state = apply(grads, state, params)
        metrics = step(_t(setup["feats"]), torch.from_numpy(setup["labels"]),
                       torch.from_numpy(setup["weights"]))
        np.testing.assert_allclose(float(metrics["loss"]), float(loss), atol=1e-4)
    want = flax_params_to_state_dict(_flax_to_numpy(params))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


def test_train_step_with_dropout_is_reproducible_from_the_generator(setup):
    """Dropout on (rates raised above SMALL_ARCH's zeros): one generator
    state gives one step, bit for bit; another seed gives another."""
    def run(seed):
        kw = dict(output_dim=1, atom_vocab_size=V, atom_pad_idx=PAD,
                  smiles_vocab_size=SMILES_VOCAB,
                  unimol_overrides={**SMALL_ARCH["unimol_overrides"], "dropout": 0.1,
                                    "attention_dropout": 0.1, "emb_dropout": 0.1},
                  chemberta_overrides=dict(SMALL_ARCH["chemberta_overrides"],
                                           max_position_embeddings=40,
                                           attention_probs_dropout_prob=0.1))
        model = build_model(**kw)
        model.load_state_dict(flax_params_to_state_dict(setup["params"]), strict=True)
        opt = FusedAdam(dict(model.named_parameters()), 1e-3, 10)
        step = build_train_step(model, opt, zoo.mse_loss, "regression")
        m = step(_t(setup["feats"]), torch.from_numpy(setup["labels"]),
                 torch.from_numpy(setup["weights"]), torch.Generator().manual_seed(seed))
        return float(m["loss"]), model.state_dict()

    (l1, p1), (l2, p2), (l3, _) = run(1), run(1), run(2)
    assert l1 == l2 and l1 != l3
    assert all(torch.equal(p1[k], p2[k]) for k in p1)


@pytest.mark.parametrize("loss_name", ["mse_loss", "mae_with_nan"])
def test_eval_batch_loss_ignores_padded_rows_like_jax(loss_name):
    rng = np.random.RandomState(5)
    logits = rng.randn(8, 2).astype(np.float32)
    labels = rng.randn(8, 2).astype(np.float32)
    jfn = {"mse_loss": jax_mse, "mae_with_nan": jax_mae_with_nan}[loss_name]
    want = _make_batch_loss(jfn)(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(5))
    got = make_batch_loss(getattr(zoo, loss_name))(torch.from_numpy(logits),
                                                   torch.from_numpy(labels), 5)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


def test_eval_step_matches_jax_forward(setup):
    model = setup["model"]
    feats = {k: jnp.asarray(v) for k, v in setup["feats"].items()}
    out = jax.jit(model.apply)({"params": setup["params"]}, **feats)
    want_loss = _make_batch_loss(jax_mse)(out["logits"], jnp.asarray(setup["labels"]),
                                          jnp.asarray(3))
    step = build_eval_step(_port_model(setup["params"]), zoo.mse_loss, lambda x: x)
    preds, loss, pooled, cls_repr = step(_t(setup["feats"]), torch.from_numpy(setup["labels"]), 3)
    np.testing.assert_allclose(preds.numpy(), np.asarray(out["logits"]), atol=1e-4)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(out["pooled"]), atol=1e-4)
    np.testing.assert_allclose(cls_repr.numpy(), np.asarray(out["cls_repr"]), atol=1e-4)
