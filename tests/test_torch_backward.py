"""The plain backward of each mmdti_tpu_torch Hopper kernel against the JAX
Pallas kernel's VJP (interpret mode, as tests/test_pallas.py runs it) and
against torch autograd through the port's plain forward, on the same numpy
inputs.  The backward is reached the way the model reaches it: through the
differentiable ops, which run the plain versions on CPU tensors.

Tolerances: attention atol 1e-4 (tests/test_pallas.py:100); gbf atol 3e-4,
rtol 1e-4 (tests/test_pallas_gbf.py:103).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmdti_tpu.ops.pallas_attention as pa
import mmdti_tpu.ops.pallas_gbf as pg
from mmdti_tpu.ops.attention import merge_padding_into_bias as jax_merge
from mmdti_tpu_torch.ops import hopper_attention as ha
from mmdti_tpu_torch.ops import hopper_gbf as hg

ATT_ATOL = 1e-4
GBF_TOL = dict(atol=3e-4, rtol=1e-4)


@pytest.fixture
def interpret_mode(monkeypatch):
    for mod in (pa, pg):
        monkeypatch.setattr(
            mod.pl, "pallas_call", functools.partial(mod.pl.pallas_call, interpret=True)
        )


def _tt(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _torch_grads(fn, inputs, cotangents):
    """Gradients of sum(out * cot) over the outputs (None cotangent: that
    output does not enter the loss)."""
    ins = [_tt(a, True) for a in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((torch.where(torch.isfinite(o), o, 0.0) * _tt(c)).sum()
               for o, c in zip(outs, cotangents) if c is not None)
    return [g.numpy() for g in torch.autograd.grad(loss, ins)]


def _close(got, want, names, **tol):
    for g, w, n in zip(got, want, names):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"grad {n}", **tol)


def _pair_case(B=2, H=4, N=16, D=8, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, N, H * D).astype(np.float32) for _ in range(3))
    pad = np.zeros((B, N), bool)
    pad[1, N - 5:] = True
    bias = np.asarray(jax_merge(jnp.asarray(rng.randn(B, H, N, N).astype(np.float32)),
                                jnp.asarray(pad)))
    g_out = rng.randn(B, N, H * D).astype(np.float32)
    # the loss reads only finite logits, so no cotangent reaches a padded key
    g_logits = np.where(np.isfinite(bias), rng.randn(B, H, N, N), 0.0).astype(np.float32)
    return q, k, v, bias, g_out, g_logits


@pytest.mark.parametrize("with_g_logits", [True, False], ids=["g_logits", "no_g_logits"])
def test_pair_bias_bwd_matches_pallas_vjp(interpret_mode, with_g_logits):
    """Padded keys (-inf bias); without g_logits the port's backward gets
    None where JAX's VJP gets zeros."""
    H = 4
    q, k, v, bias, g_out, g_logits = _pair_case(H=H)
    _, vjp = jax.vjp(lambda *a: pa.pair_bias_attention_pallas(*a, num_heads=H),
                     *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = vjp((jnp.asarray(g_out),
                jnp.asarray(g_logits if with_g_logits else np.zeros_like(g_logits))))
    got = _torch_grads(lambda *a: ha.pair_bias_attention_fused(*a, num_heads=H),
                       (q, k, v, bias), (g_out, g_logits if with_g_logits else None))
    _close(got, want, "qkvb", atol=ATT_ATOL)


def test_pair_bias_bwd_matches_autograd_of_plain_forward():
    H = 4
    q, k, v, bias, g_out, g_logits = _pair_case(H=H, N=12, seed=1)
    cots = (g_out, g_logits)
    got = _torch_grads(lambda *a: ha.pair_bias_attention_fused(*a, num_heads=H),
                       (q, k, v, bias), cots)
    want = _torch_grads(lambda *a: ha.pair_bias_attention_plain(*a, H), (q, k, v, bias), cots)
    _close(got, want, "qkvb", atol=ATT_ATOL)


def test_pair_bias_bwd_plain_takes_absent_cotangents():
    """g_out None (only the logits reach the loss) equals a zero g_out."""
    H = 2
    q, k, v, bias, _, g_logits = _pair_case(H=H, N=8, seed=2)
    args = [_tt(a) for a in (q, k, v)]
    logits = _tt(bias) + 0.5
    absent = ha.pair_bias_attention_bwd_plain(*args, logits, None, _tt(g_logits), H)
    zero = ha.pair_bias_attention_bwd_plain(*args, logits, torch.zeros_like(args[0]),
                                            _tt(g_logits), H)
    for a, b in zip(absent, zero):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _masked_case(B=2, H=4, Nq=16, Nk=24, D=8, seed=3):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Nq, H * D).astype(np.float32)
    k, v = (rng.randn(B, Nk, H * D).astype(np.float32) for _ in range(2))
    mask = np.zeros((B, Nk), np.float32)
    mask[0, Nk - 7:] = -10000.0
    return q, k, v, mask, rng.randn(B, Nq, H * D).astype(np.float32)


def test_masked_bwd_matches_pallas_vjp_nq_ne_nk(interpret_mode):
    H = 4
    q, k, v, mask, g_out = _masked_case(H=H)
    _, vjp = jax.vjp(
        lambda q, k, v: pa.masked_attention_pallas(q, k, v, jnp.asarray(mask)[:, None, :],
                                                   num_heads=H),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g_out))
    got = _torch_grads(lambda q, k, v: ha.masked_attention_fused(q, k, v, _tt(mask),
                                                                 num_heads=H),
                       (q, k, v), (g_out,))
    _close(got, want, "qkv", atol=ATT_ATOL)


def test_masked_bwd_matches_autograd_of_plain_forward():
    H = 2
    q, k, v, mask, g_out = _masked_case(H=H, Nq=8, Nk=12, D=16, seed=4)
    got = _torch_grads(lambda q, k, v: ha.masked_attention_fused(q, k, v, _tt(mask),
                                                                 num_heads=H),
                       (q, k, v), (g_out,))
    want = _torch_grads(lambda q, k, v: ha.masked_attention_plain(q, k, v, _tt(mask), H)[0],
                        (q, k, v), (g_out,))
    _close(got, want, "qkv", atol=ATT_ATOL)


def _gbf_case(B=2, N=16, K=16, H=8, seed=5):
    rng = np.random.RandomState(seed)
    p = dict(
        means=rng.uniform(0, 3, K).astype(np.float32),
        stds=rng.uniform(-3, 3, K).astype(np.float32),
        w1=(0.1 * rng.randn(K, K)).astype(np.float32),      # flax [in, out]
        b1=(0.1 * rng.randn(K)).astype(np.float32),
        w2=(0.1 * rng.randn(K, H)).astype(np.float32),
        b2=(0.1 * rng.randn(H)).astype(np.float32),
    )
    u = (rng.rand(B, N, N) * 6).astype(np.float32)
    pad = np.zeros((B, N), bool)
    pad[0, N - 4:] = True
    return u, p, pad, rng.randn(B, H, N, N).astype(np.float32)


_GBF_NAMES = ("u", "means", "stds", "w1", "b1", "w2", "b2")


def _port_gbf(pad, act="gelu_tanh"):
    def fn(u, means, stds, w1, b1, w2, b2):
        return hg.gbf_pair_bias_fused(u, means, stds, w1.t(), b1, w2.t(), b2, _tt(pad),
                                      activation=act)
    return fn


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
def test_gbf_bwd_matches_pallas_vjp_with_pad_zeroing(interpret_mode, act):
    """The JAX encoder merges -inf at padded keys with a where (zero
    gradient there); the port's fused op does it inside the kernel, and its
    backward zeroes the cotangent at those keys."""
    u, p, pad, g = _gbf_case()

    def jax_fn(u, means, stds, w1, b1, w2, b2):
        out = pg.gbf_pair_bias_fused(u, means, stds, w1, b1, w2, b2, activation=act)
        return jax_merge(jnp.transpose(out, (0, 2, 1, 3)), jnp.asarray(pad))

    inputs = (u,) + tuple(p[n] for n in _GBF_NAMES[1:])
    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in inputs))
    want = vjp(jnp.asarray(g))
    got = _torch_grads(_port_gbf(pad, act), inputs, (g,))
    _close(got, want, _GBF_NAMES, **GBF_TOL)


def test_gbf_bwd_matches_autograd_of_plain_forward():
    u, p, pad, g = _gbf_case(N=8, seed=6)
    inputs = (u,) + tuple(p[n] for n in _GBF_NAMES[1:])

    def plain(u, means, stds, w1, b1, w2, b2):
        return hg.gbf_pair_bias_plain(u, means, stds, w1.t(), b1, w2.t(), b2, _tt(pad))

    got = _torch_grads(_port_gbf(pad), inputs, (g,))
    want = _torch_grads(plain, inputs, (g,))
    _close(got, want, _GBF_NAMES, **GBF_TOL)


def test_gbf_bwd_plain_rounds_like_the_kernel_in_bf16():
    """compute_dtype=bf16 rounds the GEMM operands of the backward too: the
    gradients move by bf16 resolution, not more."""
    u, p, pad, g = _gbf_case(N=8, seed=7)
    std = torch.from_numpy(np.abs(p["stds"]) + 1e-5)
    args = (_tt(u), _tt(p["means"]), std, _tt(p["w1"].T), _tt(p["b1"]), _tt(p["w2"].T),
            _tt(g), _tt(pad))
    f32 = hg.gbf_pair_bias_bwd_plain(*args)
    bf = hg.gbf_pair_bias_bwd_plain(*args, compute_dtype=torch.bfloat16)
    assert not torch.equal(f32[3], bf[3])
    for a, b in zip(bf, f32):
        torch.testing.assert_close(a, b, atol=5e-2 * float(b.abs().max()) + 1e-6, rtol=0)
