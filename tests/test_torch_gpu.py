"""mmdti_tpu_torch Hopper kernels against their plain PyTorch versions on a
CUDA card.  Imports neither JAX nor the JAX package, so it runs on a machine
that has only torch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips.  Tolerances: fp32 atol 1e-4
(TF32 off; the sums run in another order); bf16 atol 2e-2 on outputs and
rtol 1e-2 / atol 5e-2 on the stored logits, as tests/test_pallas.py:69-73.
Gradients are held to the same bounds scaled by the largest magnitude of
the plain version's gradient (they are sums over a whole row or column).
"""

import numpy as np
import pytest
import torch

from mmdti_tpu_torch.ops import hopper_attention as ha
from mmdti_tpu_torch.ops import hopper_gbf as hg

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA device"),
]


@pytest.fixture
def cuda():
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.array(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [40, 72])
def test_pair_bias_kernel_matches_plain(cuda, dtype, N):
    B, H, D = 2, 64, 8
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, N, H * D).astype(np.float32) for _ in range(3))
    bias = rng.randn(B, H, N, N).astype(np.float32)
    bias[1, :, :, N - 7:] = -np.inf
    args = [_t(x, cuda, dtype) for x in (q, k, v, bias)]
    before = ha.pair_bias_attention_cuda.launches
    out, logits = ha.pair_bias_attention_fused(*args, num_heads=H, pair_dtype=dtype)
    assert ha.pair_bias_attention_cuda.launches == before + 1
    want_o, want_l = ha.pair_bias_attention_plain(*args, H, dtype)
    torch.testing.assert_close(out.float(), want_o.float(), atol=_tol(dtype), rtol=0)
    assert torch.equal(torch.isneginf(logits), torch.isneginf(want_l))
    fin = torch.isfinite(want_l)
    torch.testing.assert_close(
        logits[fin].float(), want_l[fin].float(),
        atol=1e-4 if dtype == torch.float32 else 5e-2,
        rtol=0 if dtype == torch.float32 else 1e-2,
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D,Nq,Nk", [(8, 64, 40, 40), (16, 32, 40, 72), (8, 16, 9, 130)])
def test_masked_kernel_matches_plain(cuda, dtype, H, D, Nq, Nk):
    B = 2
    rng = np.random.RandomState(1)
    q = rng.randn(B, Nq, H * D).astype(np.float32)
    k, v = (rng.randn(B, Nk, H * D).astype(np.float32) for _ in range(2))
    mask = np.zeros((B, Nk), np.float32)
    mask[0, Nk - 5:] = -10000.0
    args = [_t(x, cuda, dtype) for x in (q, k, v)] + [_t(mask, cuda)]
    before = ha.masked_attention_cuda.launches
    got = ha.masked_attention_fused(*args, num_heads=H)
    assert ha.masked_attention_cuda.launches == before + 1
    want = ha.masked_attention_plain(*args, H)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
def test_gbf_kernel_matches_plain(cuda, dtype, act):
    B, N, K, H = 2, 24, 128, 64
    rng = np.random.RandomState(2)
    means, stds = rng.uniform(0, 3, K), rng.uniform(0.5, 3, K)
    w1, b1 = 0.1 * rng.randn(K, K), 0.1 * rng.randn(K)
    w2, b2 = 0.1 * rng.randn(H, K), 0.1 * rng.randn(H)
    u = rng.rand(B, N, N) * 6
    pad = np.zeros((B, N), bool)
    pad[1, 20:] = True
    args = [_t(x.astype(np.float32), cuda) for x in (u, means, stds, w1, b1, w2, b2)]
    args.append(_t(pad, cuda))
    kw = dict(activation=act, pair_dtype=dtype, compute_dtype=dtype)
    before = hg.gbf_pair_bias_cuda.launches
    got = hg.gbf_pair_bias_fused(*args, **kw)
    assert hg.gbf_pair_bias_cuda.launches == before + 1
    want = hg.gbf_pair_bias_plain(*args, **kw)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin].float(), want[fin].float(), atol=_tol(dtype), rtol=0)


def test_launchers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 8, 12, device=cuda)   # H=4 -> D=3
    bias = torch.zeros(1, 4, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        ha.pair_bias_attention_cuda(q, q, q, bias, 4)
    with pytest.raises(ValueError, match="head dims"):
        ha.masked_attention_cuda(q, q, q, torch.zeros(1, 8, device=cuda), 4)
    u = torch.zeros(1, 8, 8, device=cuda)
    k16 = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="hidden, heads"):
        hg.gbf_pair_bias_cuda(u, k16, k16 + 1, torch.zeros(16, 16, device=cuda), k16,
                              torch.zeros(8, 16, device=cuda), torch.zeros(8, device=cuda),
                              None, "gelu_tanh", torch.float32, torch.float32)


def _grad_tol(dtype, want):
    return (1e-4 if dtype == torch.float32 else 2e-2) * max(1.0, float(want.float().abs().max()))


def _seed(cuda, value=1234):
    return torch.tensor([value], dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_forwards_drop_what_the_plain_versions_drop(cuda, dtype):
    B, H, D, N, rate = 2, 8, 16, 40, 0.2
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(B, N, H * D).astype(np.float32), cuda, dtype) for _ in range(3))
    bias = _t(rng.randn(B, H, N, N).astype(np.float32), cuda, dtype)
    seed = _seed(cuda)
    out, _ = ha.pair_bias_attention_cuda(q, k, v, bias, H, seed, rate)
    want, _ = ha.pair_bias_attention_plain(q, k, v, bias, H, dtype, seed, rate)
    torch.testing.assert_close(out.float(), want.float(), atol=_tol(dtype), rtol=0)
    mask = torch.zeros(B, N, device=cuda)
    got = ha.masked_attention_cuda(q, k, v, mask, H, seed, rate)
    want = ha.masked_attention_plain(q, k, v, mask, H, seed, rate)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("with_g_logits", [True, False])
def test_pair_bias_backward_kernel_matches_plain(cuda, dtype, rate, with_g_logits):
    B, H, D, N = 2, 64, 8, 72
    rng = np.random.RandomState(4)
    q, k, v, g = (_t(rng.randn(B, N, H * D).astype(np.float32), cuda, dtype) for _ in range(4))
    logits = rng.randn(B, H, N, N).astype(np.float32)
    logits[1, :, :, N - 9:] = -np.inf
    logits = _t(logits, cuda, dtype)
    gl = _t(rng.randn(B, H, N, N).astype(np.float32), cuda, dtype) if with_g_logits else None
    seed = _seed(cuda)
    before = ha.pair_bias_attention_bwd_cuda.launches
    got = ha.pair_bias_attention_bwd_cuda(q, k, v, logits, g, gl, H, seed, rate)
    assert ha.pair_bias_attention_bwd_cuda.launches == before + 1
    want = ha.pair_bias_attention_bwd_plain(q, k, v, logits, g, gl, H, seed, rate)
    again = ha.pair_bias_attention_bwd_cuda(q, k, v, logits, g, gl, H, seed, rate)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)  # deterministic
        torch.testing.assert_close(a.float(), b.float(), atol=_grad_tol(dtype, b), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("H,D,Nq,Nk", [(8, 64, 40, 40), (16, 32, 40, 72), (8, 16, 9, 130)])
def test_masked_backward_kernel_matches_plain(cuda, dtype, rate, H, D, Nq, Nk):
    B = 2
    rng = np.random.RandomState(5)
    q, g = (_t(rng.randn(B, Nq, H * D).astype(np.float32), cuda, dtype) for _ in range(2))
    k, v = (_t(rng.randn(B, Nk, H * D).astype(np.float32), cuda, dtype) for _ in range(2))
    mask = np.zeros((B, Nk), np.float32)
    mask[0, Nk - 5:] = -10000.0
    mask = _t(mask, cuda)
    seed = _seed(cuda, 77)
    got = ha.masked_attention_bwd_cuda(q, k, v, mask, g, H, seed, rate)
    want = ha.masked_attention_bwd_plain(q, k, v, mask, g, H, seed, rate)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=_grad_tol(dtype, b), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
@pytest.mark.parametrize("H", [64, 96])
def test_gbf_backward_kernel_matches_plain(cuda, dtype, act, H):
    B, N, K = 2, 24, 128
    rng = np.random.RandomState(6)
    means, std = rng.uniform(0, 3, K), rng.uniform(0.5, 3, K)
    w1, b1 = 0.1 * rng.randn(K, K), 0.1 * rng.randn(K)
    w2 = 0.1 * rng.randn(H, K)
    u = rng.rand(B, N, N) * 6
    args = [_t(x.astype(np.float32), cuda) for x in (u, means, std, w1, b1, w2)]
    g = _t(rng.randn(B, H, N, N).astype(np.float32), cuda, dtype)
    pad = np.zeros((B, N), bool)
    pad[1, 20:] = True
    pad = _t(pad, cuda)
    before = hg.gbf_pair_bias_bwd_cuda.launches
    got = hg.gbf_pair_bias_bwd_cuda(*args, g, pad, act, dtype)
    assert hg.gbf_pair_bias_bwd_cuda.launches == before + 1
    want = hg.gbf_pair_bias_bwd_plain(*args, g, pad, act, dtype)
    again = hg.gbf_pair_bias_bwd_cuda(*args, g, pad, act, dtype)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)  # deterministic
        torch.testing.assert_close(a, b, atol=_grad_tol(dtype, b), rtol=0)


def test_differentiable_ops_launch_the_backward_kernels(cuda):
    B, H, D, N = 2, 4, 16, 16
    rng = np.random.RandomState(7)
    q, k, v = (_t(rng.randn(B, N, H * D).astype(np.float32), cuda).requires_grad_()
               for _ in range(3))
    bias = _t(rng.randn(B, H, N, N).astype(np.float32), cuda).requires_grad_()
    counters = (ha.pair_bias_attention_bwd_cuda, ha.masked_attention_bwd_cuda)
    before = [c.launches for c in counters]
    out, _ = ha.pair_bias_attention_fused(q, k, v, bias, num_heads=H)
    out2 = ha.masked_attention_fused(out, k, v, torch.zeros(B, N, device=cuda), num_heads=H)
    out2.sum().backward()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v, bias))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("y_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,eps", [(2048, 512, 1e-5), (24, 136, 1e-12), (40, 1024, 1e-5)])
def test_layer_norm_kernels_match_plain(cuda, x_dtype, y_dtype, T, E, eps):
    from mmdti_tpu_torch.ops import hopper_ln as hl

    rng = np.random.RandomState(8)
    x = _t(rng.randn(T, E).astype(np.float32), cuda, x_dtype)
    w = _t((rng.rand(E) + 0.5).astype(np.float32), cuda)
    b = _t((0.1 * rng.randn(E)).astype(np.float32), cuda)
    gy = _t(rng.randn(T, E).astype(np.float32), cuda, y_dtype)
    before = (hl.layer_norm_cuda.launches, hl.layer_norm_bwd_cuda.launches,
              hl.layer_norm_bwd_reduce_cuda.launches)
    y = hl.layer_norm_cuda(x, w, b, eps, y_dtype)
    got = hl.layer_norm_bwd_cuda(x, w, gy, eps)
    assert (hl.layer_norm_cuda.launches, hl.layer_norm_bwd_cuda.launches,
            hl.layer_norm_bwd_reduce_cuda.launches) == tuple(n + 1 for n in before)
    assert y.dtype == y_dtype and got[0].dtype == x_dtype
    tol = 2e-5 if y_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), hl.layer_norm_plain(x, w, b, eps, y_dtype).float(),
                               atol=tol, rtol=0)
    want = hl.layer_norm_bwd_plain(x, w, gy, eps)
    again = hl.layer_norm_bwd_cuda(x, w, gy, eps)
    for a, c, r in zip(got, want, again):
        assert torch.equal(a, r)  # deterministic: no atomics
        torch.testing.assert_close(a.float(), c.float(), atol=_grad_tol(x_dtype, c), rtol=0)


def test_layer_norm_takes_parameter_views_at_any_offset(cuda):
    """The optimizer keeps parameters as views into one flat buffer, so
    scale and bias may start at any float offset."""
    from mmdti_tpu_torch.ops import hopper_ln as hl

    E = 512
    rng = np.random.RandomState(9)
    flat = _t(rng.randn(2 * E + 1).astype(np.float32), cuda)
    w, b = flat[1:E + 1], flat[E + 1:]
    x = _t(rng.randn(64, E).astype(np.float32), cuda)
    torch.testing.assert_close(hl.layer_norm_cuda(x, w, b, 1e-5, torch.float32),
                               hl.layer_norm_plain(x, w, b, 1e-5), atol=2e-5, rtol=0)
