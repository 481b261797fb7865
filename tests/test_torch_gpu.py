"""mmdti_tpu_torch Hopper kernels against their plain PyTorch versions on a
CUDA card.  Imports neither JAX nor the JAX package, so it runs on a machine
that has only torch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips.  Tolerances: fp32 atol 1e-4
(TF32 off; the sums run in another order); bf16 atol 2e-2 on outputs and
rtol 1e-2 / atol 5e-2 on the stored logits, as tests/test_pallas.py:69-73.
Gradients are held to the same bounds scaled by the largest magnitude of
the plain version's gradient (they are sums over a whole row or column).
bf16 attention (bf16 q/k/v, and a bf16 pair for pair-bias) runs the
tensor-core ("mma") route, anything fp32 the row kernels; the route counters
say which ran.
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
    want_o, want_l, _ = ha.pair_bias_attention_plain(*args, H, dtype)
    torch.testing.assert_close(out.float(), want_o.float(), atol=_tol(dtype), rtol=0)
    assert torch.equal(torch.isneginf(logits), torch.isneginf(want_l))
    fin = torch.isfinite(want_l)
    torch.testing.assert_close(
        logits[fin].float(), want_l[fin].float(),
        atol=1e-4 if dtype == torch.float32 else 5e-2,
        rtol=0 if dtype == torch.float32 else 1e-2,
    )


# (H, D, Nq, Nk): the flagship heads, tile edges of the 64-row tensor-core
# tiles (1, 63, 65), the cross-modal (280, 512) and ChemBERTa's top bucket
MASKED_SHAPES = [(8, 64, 40, 40), (16, 32, 40, 72), (8, 16, 9, 130), (8, 8, 65, 63),
                 (8, 64, 1, 1), (8, 64, 63, 65), (16, 32, 65, 1), (16, 32, 280, 512),
                 (8, 64, 512, 512)]
FMIN = float(np.finfo(np.float32).min)


def _masked_mask(B, Nk, fill):
    """Batch row 0 masks its last 5 keys; with finfo.min, row 1 masks all."""
    mask = np.zeros((B, Nk), np.float32)
    mask[0, max(0, Nk - 5):] = fill
    if fill == FMIN:
        mask[1, :] = fill
    return mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fill", [-10000.0, FMIN])
@pytest.mark.parametrize("H,D,Nq,Nk", MASKED_SHAPES)
def test_masked_kernel_matches_plain(cuda, dtype, fill, H, D, Nq, Nk):
    B = 2
    rng = np.random.RandomState(1)
    q = rng.randn(B, Nq, H * D).astype(np.float32)
    k, v = (rng.randn(B, Nk, H * D).astype(np.float32) for _ in range(2))
    args = [_t(x, cuda, dtype) for x in (q, k, v)] + [_t(_masked_mask(B, Nk, fill), cuda)]
    route = "mma" if dtype == torch.bfloat16 else "rows"
    before = ha.masked_attention_cuda.launches, dict(ha.masked_attention_cuda.routes)
    got = ha.masked_attention_fused(*args, num_heads=H)
    assert ha.masked_attention_cuda.launches == before[0] + 1
    assert ha.masked_attention_cuda.routes[route] == before[1][route] + 1
    want, want_s = ha.masked_attention_plain(*args, H)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=0)
    if route == "mma":
        out, stats = ha.masked_attention_cuda(*args, H)
        torch.testing.assert_close(out.float(), want.float(), atol=_tol(dtype), rtol=0)
        torch.testing.assert_close(stats[..., 0], want_s[..., 0], atol=1e-2, rtol=1e-3)
        torch.testing.assert_close(stats[..., 1], want_s[..., 1], atol=0, rtol=1e-2)


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
    flat = torch.zeros(8 * 32 + 1, device=cuda, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 8, 32)   # contiguous, 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        ha.masked_attention_cuda(odd, odd, odd, torch.zeros(1, 8, device=cuda), 4)
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
    out, _, _ = ha.pair_bias_attention_cuda(q, k, v, bias, H, seed, rate)
    want = ha.pair_bias_attention_plain(q, k, v, bias, H, dtype, seed, rate)[0]
    torch.testing.assert_close(out.float(), want.float(), atol=_tol(dtype), rtol=0)
    mask = torch.zeros(B, N, device=cuda)
    got, _ = ha.masked_attention_cuda(q, k, v, mask, H, seed, rate)
    want, _ = ha.masked_attention_plain(q, k, v, mask, H, seed, rate)
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("with_g_logits", [True, False])
def test_pair_bias_backward_kernel_matches_plain(cuda, dtype, rate, with_g_logits):
    """The backward from the forward kernel's logits (and, on the bf16
    route, its out and row stats) against the recompute oracle."""
    B, H, D, N = 2, 64, 8, 72
    rng = np.random.RandomState(4)
    q, k, v, g = (_t(rng.randn(B, N, H * D).astype(np.float32), cuda, dtype) for _ in range(4))
    bias = rng.randn(B, H, N, N).astype(np.float32)
    bias[1, :, :, N - 9:] = -np.inf
    bias = _t(bias, cuda, dtype)
    gl = _t(rng.randn(B, H, N, N).astype(np.float32), cuda, dtype) if with_g_logits else None
    seed = _seed(cuda)
    out, logits, stats = ha.pair_bias_attention_cuda(q, k, v, bias, H, seed, rate)
    before = ha.pair_bias_attention_bwd_cuda.launches
    got = ha.pair_bias_attention_bwd_cuda(q, k, v, logits, out, stats, g, gl, H, seed, rate)
    assert ha.pair_bias_attention_bwd_cuda.launches == before + 1
    want = ha.pair_bias_attention_bwd_plain(q, k, v, logits, g, gl, H, seed, rate)
    again = ha.pair_bias_attention_bwd_cuda(q, k, v, logits, out, stats, g, gl, H, seed, rate)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)  # deterministic
        torch.testing.assert_close(a.float(), b.float(), atol=_grad_tol(dtype, b), rtol=0)


# (N, rate, cotangents): tile edges of the 64-row tensor-core tiles (8, 64,
# 65 with rows that are not 16-byte aligned) and the top atom bucket 280
PAIR_MMA_CASES = [(N, rate, cot) for N in (8, 64, 65, 280) for rate in (0.0, 0.1)
                  for cot in ("both", "no_g_logits", "no_g_out")]


@pytest.mark.parametrize("N,rate,cot", PAIR_MMA_CASES)
def test_pair_bias_mma_kernels_match_plain(cuda, N, rate, cot):
    """bf16 q/k/v and pair: the tensor-core forward against the plain
    version (out, logits, row stats), the one-launch backward against the
    stats plain version and the recompute oracle, repeated backwards
    bit-equal, every launch on the "mma" route."""
    B, H, D = 2, 64, 8
    bf = torch.bfloat16
    rng = np.random.RandomState(11)
    q, k, v, g = (_t(rng.randn(B, N, H * D).astype(np.float32), cuda, bf) for _ in range(4))
    bias = rng.randn(B, H, N, N).astype(np.float32)
    bias[1, :, :, max(1, N - 9):] = -np.inf
    bias[0, :, N // 2, :] = -np.inf   # a query row that sees no key
    bias = _t(bias, cuda, bf)
    gl = _t(rng.randn(B, H, N, N).astype(np.float32), cuda, bf)
    g = None if cot == "no_g_out" else g
    gl = None if cot == "no_g_logits" else gl
    seed = _seed(cuda, 31) if rate else None
    routes = dict(ha.pair_bias_attention_cuda.routes), dict(ha.pair_bias_attention_bwd_cuda.routes)

    out, logits, stats = ha.pair_bias_attention_cuda(q, k, v, bias, H, seed, rate)
    want_o, want_l, want_s = ha.pair_bias_attention_plain(q, k, v, bias, H, bf, seed, rate)
    torch.testing.assert_close(out.float(), want_o.float(), atol=2e-2, rtol=0)
    assert torch.equal(torch.isneginf(logits), torch.isneginf(want_l))
    fin = torch.isfinite(want_l)
    torch.testing.assert_close(logits[fin].float(), want_l[fin].float(), atol=5e-2, rtol=1e-2)
    assert torch.equal(out[0, N // 2], torch.zeros_like(out[0, N // 2]))   # the guard
    torch.testing.assert_close(stats[..., 0], want_s[..., 0], atol=1e-2, rtol=1e-3)
    torch.testing.assert_close(stats[..., 1], want_s[..., 1], atol=0, rtol=1e-2)

    got = ha.pair_bias_attention_bwd_cuda(q, k, v, logits, out, stats, g, gl, H, seed, rate)
    again = ha.pair_bias_attention_bwd_cuda(q, k, v, logits, out, stats, g, gl, H, seed, rate)
    plain = ha.pair_bias_attention_stats_bwd_plain(q, k, v, logits, out, stats, g, gl, H, seed,
                                                   rate)
    oracle = ha.pair_bias_attention_bwd_plain(q, k, v, logits, g, gl, H, seed, rate)
    for a, b, c, o in zip(got, again, plain, oracle):
        assert torch.equal(a, b)  # deterministic: no atomics
        torch.testing.assert_close(a.float(), c.float(), atol=_grad_tol(bf, c), rtol=0)
        torch.testing.assert_close(a.float(), o.float(), atol=_grad_tol(bf, o), rtol=0)
    if g is None:
        assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert ha.pair_bias_attention_cuda.routes == {**routes[0], "mma": routes[0]["mma"] + 1}
    assert ha.pair_bias_attention_bwd_cuda.routes == {**routes[1], "mma": routes[1]["mma"] + 2}


@pytest.mark.parametrize("qkv,pair", [(torch.float32, torch.float32),
                                      (torch.bfloat16, torch.float32),
                                      (torch.float32, torch.bfloat16)])
def test_pair_bias_with_fp32_stays_on_the_row_kernels(cuda, qkv, pair):
    B, H, D, N = 2, 8, 8, 40
    rng = np.random.RandomState(12)
    q, k, v, g = (_t(rng.randn(B, N, H * D).astype(np.float32), cuda, qkv) for _ in range(4))
    bias = _t(rng.randn(B, H, N, N).astype(np.float32), cuda, pair)
    routes = dict(ha.pair_bias_attention_cuda.routes), dict(ha.pair_bias_attention_bwd_cuda.routes)
    out, logits, stats = ha.pair_bias_attention_cuda(q, k, v, bias, H)
    assert stats is None
    got = ha.pair_bias_attention_bwd_cuda(q, k, v, logits, None, None, g, None, H)
    want = ha.pair_bias_attention_bwd_plain(q, k, v, logits, g, None, H)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=_grad_tol(torch.bfloat16, b),
                                   rtol=0)
    assert ha.pair_bias_attention_cuda.routes == {**routes[0], "rows": routes[0]["rows"] + 1}
    assert ha.pair_bias_attention_bwd_cuda.routes == {**routes[1], "rows": routes[1]["rows"] + 1}


def test_bf16_attention_ops_launch_the_mma_kernels(cuda):
    """Both differentiable ops in bf16 (a bf16 pair for pair-bias) go to the
    tensor-core route, forward and backward, and their gradients match the
    oracles."""
    B, H, D, N = 2, 8, 8, 70
    bf = torch.bfloat16
    rng = np.random.RandomState(13)
    q, k, v = (_t(rng.randn(B, N, H * D).astype(np.float32), cuda, bf).requires_grad_()
               for _ in range(3))
    bias = _t(rng.randn(B, H, N, N).astype(np.float32), cuda, bf).requires_grad_()
    mask = torch.zeros(B, N, device=cuda)
    counters = (ha.pair_bias_attention_cuda, ha.pair_bias_attention_bwd_cuda,
                ha.masked_attention_cuda, ha.masked_attention_bwd_cuda)
    before = [c.routes["mma"] for c in counters]
    seed = _seed(cuda, 5)
    out, logits = ha.pair_bias_attention_fused(q, k, v, bias, num_heads=H, pair_dtype=bf,
                                               dropout_rate=0.1, seed=seed, deterministic=False)
    out2 = ha.masked_attention_fused(out, k, v, mask, num_heads=H)
    g2 = _t(rng.randn(B, N, H * D).astype(np.float32), cuda, bf)
    gl = _t(rng.randn(B, H, N, N).astype(np.float32), cuda, bf)
    grads = torch.autograd.grad((out2, logits), (q, k, v, bias), (g2, gl))
    assert [c.routes["mma"] for c in counters] == [n + 1 for n in before]
    assert all(torch.isfinite(t).all() for t in grads)
    # the pair-bias op alone against the oracle
    out, logits = ha.pair_bias_attention_fused(q, k, v, bias, num_heads=H, pair_dtype=bf,
                                               dropout_rate=0.1, seed=seed, deterministic=False)
    grads = torch.autograd.grad((out, logits), (q, k, v, bias), (g2, gl))
    want = ha.pair_bias_attention_bwd_plain(q.detach(), k.detach(), v.detach(), logits.detach(),
                                            g2, gl, H, seed, 0.1)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a.float(), b.float(), atol=_grad_tol(bf, b), rtol=0)


@pytest.mark.parametrize("D,N", [(16, 130), (32, 65), (64, 130)])
def test_pair_bias_mma_kernels_at_other_head_dims(cuda, D, N):
    """The other instantiated head dims of the tensor-core kernels, over
    more than one 64-row tile, with dropout."""
    B, H = 2, 4
    bf = torch.bfloat16
    rng = np.random.RandomState(14)
    q, k, v, g = (_t(rng.randn(B, N, H * D).astype(np.float32), cuda, bf) for _ in range(4))
    bias = rng.randn(B, H, N, N).astype(np.float32)
    bias[1, :, :, N - 3:] = -np.inf
    bias = _t(bias, cuda, bf)
    gl = _t(rng.randn(B, H, N, N).astype(np.float32), cuda, bf)
    seed = _seed(cuda, 17)
    out, logits, stats = ha.pair_bias_attention_cuda(q, k, v, bias, H, seed, 0.1)
    want_o, want_l, _ = ha.pair_bias_attention_plain(q, k, v, bias, H, bf, seed, 0.1)
    torch.testing.assert_close(out.float(), want_o.float(), atol=2e-2, rtol=0)
    fin = torch.isfinite(want_l)
    torch.testing.assert_close(logits[fin].float(), want_l[fin].float(), atol=5e-2, rtol=1e-2)
    got = ha.pair_bias_attention_bwd_cuda(q, k, v, logits, out, stats, g, gl, H, seed, 0.1)
    want = ha.pair_bias_attention_stats_bwd_plain(q, k, v, logits, out, stats, g, gl, H, seed,
                                                  0.1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=_grad_tol(bf, b), rtol=0)


def test_bf16_pair_bias_backward_rejects_what_it_does_not_take(cuda):
    B, H, D, N = 1, 2, 64, 449   # dq and the row stats outgrow shared memory
    bf = torch.bfloat16
    q = torch.zeros(B, N, H * D, device=cuda, dtype=bf)
    logits = torch.zeros(B, H, N, N, device=cuda, dtype=bf)
    stats = torch.zeros(B, H, N, 2, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ha.pair_bias_attention_bwd_cuda(q, q, q, logits, q, stats, q, None, H)
    with pytest.raises(ValueError, match="out and stats"):
        ha.pair_bias_attention_bwd_cuda(q, q, q, logits, None, None, q, None, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("fill", [-10000.0, FMIN])
@pytest.mark.parametrize("H,D,Nq,Nk", MASKED_SHAPES)
def test_masked_backward_kernel_matches_plain(cuda, dtype, rate, fill, H, D, Nq, Nk):
    B = 2
    rng = np.random.RandomState(5)
    q, g = (_t(rng.randn(B, Nq, H * D).astype(np.float32), cuda, dtype) for _ in range(2))
    k, v = (_t(rng.randn(B, Nk, H * D).astype(np.float32), cuda, dtype) for _ in range(2))
    mask = _t(_masked_mask(B, Nk, fill), cuda)
    seed = _seed(cuda, 77)
    route = "mma" if dtype == torch.bfloat16 else "rows"
    out, stats = ha.masked_attention_cuda(q, k, v, mask, H, seed, rate)
    before = ha.masked_attention_bwd_cuda.routes[route]
    got = ha.masked_attention_bwd_cuda(q, k, v, mask, out, stats, g, H, seed, rate)
    assert ha.masked_attention_bwd_cuda.routes[route] == before + 1
    want = ha.masked_attention_bwd_plain(q, k, v, mask, g, H, seed, rate)
    # With one key the softmax has no gradient: dq = dk = 0 exactly.  The mma
    # route's r = rowsum(g_out * out) then carries only the bf16 rounding of
    # the stored out (scaled by 1/(1-rate) under dropout), which its own plain
    # version below reproduces; the oracle holds dv alone there.
    skip = 2 if route == "mma" and Nk == 1 and rate > 0 else 0
    for a, b in list(zip(got, want))[skip:]:
        torch.testing.assert_close(a.float(), b.float(), atol=_grad_tol(dtype, b), rtol=0)
    if route == "mma":
        again = ha.masked_attention_bwd_cuda(q, k, v, mask, out, stats, g, H, seed, rate)
        plain = ha.masked_attention_stats_bwd_plain(q, k, v, mask, out, stats, g, H, seed, rate)
        for a, b, c in zip(got, again, plain):
            assert torch.equal(a, b)  # deterministic: no atomics
            torch.testing.assert_close(a.float(), c.float(), atol=_grad_tol(dtype, c), rtol=0)


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


def test_bf16_masked_op_saves_stats_and_launches_the_mma_backward(cuda):
    B, H, D, Nq, Nk = 2, 8, 64, 70, 130
    rng = np.random.RandomState(10)
    q = _t(rng.randn(B, Nq, H * D).astype(np.float32), cuda, torch.bfloat16).requires_grad_()
    k, v = (_t(rng.randn(B, Nk, H * D).astype(np.float32), cuda,
               torch.bfloat16).requires_grad_() for _ in range(2))
    mask = _t(_masked_mask(B, Nk, FMIN), cuda)
    g = _t(rng.randn(B, Nq, H * D).astype(np.float32), cuda, torch.bfloat16)
    before = ha.masked_attention_bwd_cuda.routes["mma"]
    out = ha.masked_attention_fused(q, k, v, mask, num_heads=H, dropout_rate=0.1,
                                    seed=_seed(cuda), deterministic=False)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert ha.masked_attention_bwd_cuda.routes["mma"] == before + 1
    want = ha.masked_attention_bwd_plain(q.detach(), k.detach(), v.detach(), mask, g, H,
                                         _seed(cuda), 0.1)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=_grad_tol(torch.bfloat16, b),
                                   rtol=0)


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
