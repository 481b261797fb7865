"""The fused LayerNorm of mmdti_tpu_torch on the CPU against the JAX
package's Pallas kernel, run in interpret mode as tests/test_pallas_ln.py
runs it: the plain forward (atol/rtol 2e-5, the JAX test's tolerance), the
plain backward that the differentiable op runs for CPU tensors (1e-4, eps
1e-5 and the BERT sites' 1e-12), and the gate's decisions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmdti_tpu.ops.pallas_ln as pln
from mmdti_tpu_torch.models.layers import FusedLN
from mmdti_tpu_torch.ops import hopper_ln as hl

SHAPES = [((4, 16, 512), "bfloat16"), ((8, 128), "float32"),
          ((2, 3, 8, 256), "bfloat16"), ((64, 128), "float32")]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pln.pl, "pallas_call",
                        functools.partial(pln.pl.pallas_call, interpret=True))


def _inputs(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    g = (rng.rand(shape[-1]) + 0.5).astype(np.float32)
    b = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    # the same rounded values on both sides
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TORCH_DT[dtype])
    return (jx, jnp.asarray(g), jnp.asarray(b)), (tx, torch.from_numpy(g), torch.from_numpy(b))


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("fn", ["plain", "fused"])
@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_forward_matches_pallas(shape, dtype, fn):
    (jx, jg, jb), (tx, tg, tb) = _inputs(shape, dtype)
    want = pln.layer_norm_fused(jx, jg, jb, epsilon=1e-5)
    if fn == "plain":
        got = hl.layer_norm_plain(tx, tg, tb, 1e-5)
    else:
        got = hl.layer_norm_fused(tx, tg, tb, 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_out_dtype_matches_pallas(out_dtype):
    (jx, jg, jb), (tx, tg, tb) = _inputs((8, 128), "bfloat16")
    want = pln.layer_norm_fused(jx, jg, jb, out_dtype=jnp.dtype(out_dtype))
    got = hl.layer_norm_fused(tx, tg, tb, out_dtype=TORCH_DT[out_dtype])
    assert got.dtype == TORCH_DT[out_dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fn", ["plain", "fused"])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_grads_match_pallas(eps, fn):
    """The JAX test's case: x bf16 [4,16,512], loss mean(y^2) in fp32; dx
    in x's dtype, dscale/dbias fp32, all within 1e-4."""
    (jx, jg, jb), (tx, tg, tb) = _inputs((4, 16, 512), "bfloat16")

    def loss_jax(x, g, b):
        y = pln.layer_norm_fused(x, g, b, epsilon=eps)
        return (y.astype(jnp.float32) ** 2).mean()

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(jx, jg, jb)
    tx, tg, tb = (t.clone().requires_grad_() for t in (tx, tg, tb))
    op = hl.layer_norm_plain if fn == "plain" else hl.layer_norm_fused
    (op(tx, tg, tb, eps).float() ** 2).mean().backward()
    for got, w in zip((tx.grad, tg.grad, tb.grad), want):
        assert got.dtype == TORCH_DT[str(w.dtype)]
        np.testing.assert_allclose(_f32(got), _f32(w), atol=1e-4, rtol=1e-4)


def test_plain_backward_is_the_kernel_arithmetic():
    """layer_norm_bwd_plain (what the kernel computes) equals autograd of the
    plain forward, over several rows of fp32 input."""
    _, (tx, tg, tb) = _inputs((64, 128), "float32", seed=3)
    gy = torch.from_numpy(np.random.RandomState(4).randn(64, 128).astype(np.float32))
    x = tx.clone().requires_grad_()
    g = tg.clone().requires_grad_()
    b = tb.clone().requires_grad_()
    hl.layer_norm_plain(x, g, b, 1e-5).backward(gy)
    dx, dg, db = hl.layer_norm_bwd_plain(tx, tg, gy, 1e-5)
    for got, want in ((dx, x.grad), (dg, g.grad), (db, b.grad)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


GATE_SHAPES = [(8, 100), (3, 128), (128,), (4, 16, 512), (8, 128), (0, 128), (4, 6, 64),
               (2, 3, 8, 256)]


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_gate_decides_as_the_jax_gate(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("MMDTI_PALLAS_LN", raising=False)
    else:
        monkeypatch.setenv("MMDTI_PALLAS_LN", env)
    for shape in GATE_SHAPES:
        assert hl.layer_norm_supported(shape) == pln.layer_norm_supported(shape), shape
        for flag in (True, False):
            assert hl.ln_kernel_enabled(flag, shape) == pln.ln_kernel_enabled(flag, shape), (
                shape, flag)


def test_module_takes_the_op_only_when_enabled(monkeypatch):
    calls = []
    real = hl.LayerNormFn.apply
    monkeypatch.setattr(hl.LayerNormFn, "apply", lambda *a: calls.append(1) or real(*a))
    _, (tx, _, _) = _inputs((4, 16, 512), "bfloat16")
    ln_k, ln_p = FusedLN(512, 1e-12, use_kernels=True), FusedLN(512, 1e-12)
    monkeypatch.setenv("MMDTI_PALLAS_LN", "1")
    y_k = ln_k(tx, out_dtype=torch.float32)
    assert calls == [1]
    y_p = ln_p(tx, out_dtype=torch.float32)
    assert calls == [1]
    torch.testing.assert_close(y_k, y_p, atol=2e-5, rtol=2e-5)
    # E=64 (the final head LayerNorm) stays on the plain path
    FusedLN(64, use_kernels=True)(torch.zeros(4, 6, 64))
    monkeypatch.setenv("MMDTI_PALLAS_LN", "0")
    ln_k(tx)
    assert calls == [1]


def test_launchers_refuse_cpu_tensors():
    x = torch.zeros(8, 128)
    w = torch.ones(128)
    with pytest.raises(ValueError, match="CUDA"):
        hl.layer_norm_cuda(x, w, w, 1e-5, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        hl.layer_norm_bwd_cuda(x, w, x, 1e-5)
    with pytest.raises(ValueError, match="unsupported"):
        hl.layer_norm_fused(torch.zeros(8, 100), torch.ones(100), torch.zeros(100))
