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
tensor-core ("mma") route, anything fp32 the row kernels; the gbf pair runs
"mma" for bf16 compute at K = Kh = 128, H 64 or 96, and its FMA kernels
("fma") for fp32 compute; the route counters say which ran.
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


GBF_NS = [8, 24, 64, 65, 280]
GBF_COMPUTE = {"fma": torch.float32, "mma": torch.bfloat16}   # route -> compute dtype


def _gbf_inputs(cuda, rng, B, N, H, K=128, Kh=128):
    means, stds = rng.uniform(0, 3, K), rng.uniform(0.5, 3, K)
    w1, b1 = 0.1 * rng.randn(Kh, K), 0.1 * rng.randn(Kh)
    w2, b2 = 0.1 * rng.randn(H, Kh), 0.1 * rng.randn(H)
    u = rng.rand(B, N, N) * 6
    pad = np.zeros((B, N), bool)
    pad[1, N - max(1, N // 6):] = True
    args = [_t(x.astype(np.float32), cuda) for x in (u, means, stds, w1, b1, w2, b2)]
    return args, _t(pad, cuda)


@pytest.mark.parametrize("route", ["fma", "mma"])
@pytest.mark.parametrize("pair", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
@pytest.mark.parametrize("N", GBF_NS)
@pytest.mark.parametrize("H", [16, 32, 48, 64, 96])
def test_gbf_kernel_matches_plain(cuda, route, pair, act, N, H):
    """Both routes against the plain forward; the flat 16-pair tiles of the
    "mma" route cross row and batch ends at every N here, and N=65 keeps no
    16-byte alignment (its stores go one element a lane)."""
    compute = GBF_COMPUTE[route]
    args, pad = _gbf_inputs(cuda, np.random.RandomState(2), 2, N, H)
    args.append(pad)
    kw = dict(activation=act, pair_dtype=pair, compute_dtype=compute)
    assert hg.gbf_route(compute, 128, 128, H) == route
    before, routes = hg.gbf_pair_bias_cuda.launches, dict(hg.gbf_pair_bias_cuda.routes)
    got = hg.gbf_pair_bias_fused(*args, **kw)
    assert hg.gbf_pair_bias_cuda.launches == before + 1
    assert hg.gbf_pair_bias_cuda.routes[route] == routes[route] + 1
    want = hg.gbf_pair_bias_plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == pair and got.shape == (2, H, N, N)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    tol = _tol(torch.bfloat16 if torch.bfloat16 in (pair, compute) else torch.float32)
    torch.testing.assert_close(got[fin].float(), want[fin].float(), atol=tol, rtol=0)


@pytest.mark.parametrize("pair", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
@pytest.mark.parametrize("N", [24, 65])
@pytest.mark.parametrize("K", [64, 192])
def test_gbf_fma_route_takes_bf16_compute(cuda, pair, act, N, K):
    """bf16 compute off the tensor-core widths (K != 128) runs the FMA
    forward with its operands rounded to bf16."""
    args, pad = _gbf_inputs(cuda, np.random.RandomState(4), 2, N, 64, K=K)
    args.append(pad)
    kw = dict(activation=act, pair_dtype=pair, compute_dtype=torch.bfloat16)
    assert hg.gbf_route(torch.bfloat16, K, 128, 64) == "fma"
    routes = dict(hg.gbf_pair_bias_cuda.routes)
    got = hg.gbf_pair_bias_fused(*args, **kw)
    assert hg.gbf_pair_bias_cuda.routes == {**routes, "fma": routes["fma"] + 1}
    want = hg.gbf_pair_bias_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin].float(), want[fin].float(),
                               atol=_tol(torch.bfloat16), rtol=0)


def test_gbf_fma_forward_takes_a_larger_K_after_a_smaller_one(cuda):
    """The FMA forward's shared memory grows with K, which is not a template
    parameter: one instantiation must take a larger K after a smaller one."""
    for K in (32, 192):
        args, pad = _gbf_inputs(cuda, np.random.RandomState(K), 2, 24, 64, K=K)
        args.append(pad)
        got = hg.gbf_pair_bias_fused(*args, activation="gelu", compute_dtype=torch.float32)
        want = hg.gbf_pair_bias_plain(*args, activation="gelu", compute_dtype=torch.float32)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[fin], want[fin], atol=_tol(torch.float32), rtol=0)


def test_gbf_fp32_compute_lands_on_the_fma_route(cuda):
    args, pad = _gbf_inputs(cuda, np.random.RandomState(3), 2, 16, 64)
    fwd, bwd = dict(hg.gbf_pair_bias_cuda.routes), dict(hg.gbf_pair_bias_bwd_cuda.routes)
    u = args[0].requires_grad_()
    out = hg.gbf_pair_bias_fused(u, *args[1:], pad, compute_dtype=torch.float32)
    out.masked_fill(torch.isneginf(out), 0).sum().backward()
    assert hg.gbf_pair_bias_cuda.routes == {**fwd, "fma": fwd["fma"] + 1}
    assert hg.gbf_pair_bias_bwd_cuda.routes == {**bwd, "fma": bwd["fma"] + 1}
    assert hg.gbf_route(torch.bfloat16, 64, 128, 64) == "fma"
    assert hg.gbf_route(torch.bfloat16, 128, 128, 96) == "mma"


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


@pytest.mark.parametrize("route", ["fma", "mma"])
@pytest.mark.parametrize("pair", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
@pytest.mark.parametrize("N", GBF_NS)
@pytest.mark.parametrize("H", [16, 32, 48, 64, 96])
def test_gbf_backward_kernel_matches_plain(cuda, route, pair, act, N, H):
    """Both routes against the plain backward, repeated calls bit-equal."""
    compute = GBF_COMPUTE[route]
    rng = np.random.RandomState(6)
    args, pad = _gbf_inputs(cuda, rng, 2, N, H)
    args = args[:6]
    g = _t(rng.randn(2, H, N, N).astype(np.float32), cuda, pair)
    before, routes = hg.gbf_pair_bias_bwd_cuda.launches, dict(hg.gbf_pair_bias_bwd_cuda.routes)
    got = hg.gbf_pair_bias_bwd_cuda(*args, g, pad, act, compute)
    assert hg.gbf_pair_bias_bwd_cuda.launches == before + 1
    assert hg.gbf_pair_bias_bwd_cuda.routes[route] == routes[route] + 1
    want = hg.gbf_pair_bias_bwd_plain(*args, g, pad, act, compute)
    again = hg.gbf_pair_bias_bwd_cuda(*args, g, pad, act, compute)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, c)  # deterministic
        torch.testing.assert_close(a, b, atol=_grad_tol(compute, b), rtol=0)


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
@pytest.mark.parametrize("T,E,eps", [(2048, 512, 1e-5), (24, 136, 1e-12), (40, 1024, 1e-5),
                                     (8, 512, 1e-12), (8960, 512, 1e-5), (16384, 768, 1e-5)])
def test_layer_norm_kernels_match_plain(cuda, x_dtype, y_dtype, T, E, eps):
    from mmdti_tpu_torch.ops import hopper_ln as hl

    rng = np.random.RandomState(8)
    x = _t(rng.randn(T, E).astype(np.float32), cuda, x_dtype)
    w = _t((rng.rand(E) + 0.5).astype(np.float32), cuda)
    b = _t((0.1 * rng.randn(E)).astype(np.float32), cuda)
    gy = _t(rng.randn(T, E).astype(np.float32), cuda, y_dtype)
    before = (hl.layer_norm_cuda.launches, hl.layer_norm_bwd_cuda.launches)
    y = hl.layer_norm_cuda(x, w, b, eps, y_dtype)
    got = hl.layer_norm_bwd_cuda(x, w, gy, eps)
    # one launch each way: the backward's dscale/dbias need no second kernel
    assert (hl.layer_norm_cuda.launches, hl.layer_norm_bwd_cuda.launches) == tuple(
        n + 1 for n in before)
    assert not hasattr(hl, "layer_norm_bwd_reduce_cuda")
    assert y.dtype == y_dtype and got[0].dtype == x_dtype
    tol = 2e-5 if y_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), hl.layer_norm_plain(x, w, b, eps, y_dtype).float(),
                               atol=tol, rtol=0)
    want = hl.layer_norm_bwd_plain(x, w, gy, eps)
    again = hl.layer_norm_bwd_cuda(x, w, gy, eps)
    for a, c, r in zip(got, want, again):
        assert torch.equal(a, r)  # deterministic: no atomics
        torch.testing.assert_close(a.float(), c.float(), atol=_grad_tol(x_dtype, c), rtol=0)


def test_layer_norm_backward_repeats_bit_equal_after_another_T(cuda):
    """A backward at T=2048, one at T=24, and T=2048 again: the two T=2048
    results are bit-equal, and every ticket is back at 0 (a ticket or
    scratch that the kernel failed to reset would show here)."""
    from mmdti_tpu_torch.ops import hopper_ln as hl

    rng = np.random.RandomState(10)
    E = 512
    w = _t((rng.rand(E) + 0.5).astype(np.float32), cuda)
    x, gy, x24, gy24 = (_t(rng.randn(T, E).astype(np.float32), cuda, torch.bfloat16)
                        for T in (2048, 2048, 24, 24))
    first = hl.layer_norm_bwd_cuda(x, w, gy, 1e-5)
    between = hl.layer_norm_bwd_cuda(x24, w, gy24, 1e-5)
    again = hl.layer_norm_bwd_cuda(x, w, gy, 1e-5)
    torch.cuda.synchronize()
    for a, r in zip(first, again):
        assert torch.equal(a, r)
    want = hl.layer_norm_bwd_plain(x24, w, gy24, 1e-5)
    for a, c in zip(between, want):
        torch.testing.assert_close(a.float(), c.float(),
                                   atol=_grad_tol(torch.bfloat16, c), rtol=0)
    assert all(bool((tickets == 0).all()) for _, tickets in hl._SCRATCH.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_takes_parameter_views_at_any_offset(cuda, dtype):
    """The optimizer keeps parameters as views into one flat buffer, so
    scale and bias may start at any float offset: forward and backward."""
    from mmdti_tpu_torch.ops import hopper_ln as hl

    E = 512
    rng = np.random.RandomState(9)
    flat = _t(rng.randn(2 * E + 1).astype(np.float32), cuda)
    w, b = flat[1:E + 1], flat[E + 1:]
    x = _t(rng.randn(64, E).astype(np.float32), cuda, dtype)
    gy = _t(rng.randn(64, E).astype(np.float32), cuda, dtype)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(hl.layer_norm_cuda(x, w, b, 1e-5, dtype).float(),
                               hl.layer_norm_plain(x, w, b, 1e-5).float(), atol=tol, rtol=0)
    want = hl.layer_norm_bwd_plain(x, w, gy, 1e-5)
    for a, c in zip(hl.layer_norm_bwd_cuda(x, w, gy, 1e-5), want):
        torch.testing.assert_close(a.float(), c.float(), atol=_grad_tol(dtype, c), rtol=0)


# ---- K train steps and the eval sweep as CUDA graph replays --------------------

GRAPH_V, GRAPH_PAD = 12, 1


def _graph_setup(cuda, fds=False, R=40, N=24, L=20, seed=0, freeze=None, use_kernels=True):
    """A shallow bf16 model on the kernel path (or, with ``use_kernels``
    False, the plain path) at the flagship widths the
    kernels take (E=512 and 64 Uni-Mol heads for the gbf kernels, so
    pair-bias D=8; masked D=64 and 32; every dropout of the flagship on),
    its optimizer and generator, the train programs and a resident dataset
    of R rows made with numpy.  ``freeze`` (freeze_layers, freeze_module)
    freezes as NNModel does."""
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.losses.fds import init_fds_state
    from mmdti_tpu_torch.models.mm_model import build_model
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import Resident, TrainPrograms

    model = build_model(1, GRAPH_V, GRAPH_PAD, 40, compute_dtype="bfloat16",
                        use_kernels=use_kernels,
                        unimol_overrides=dict(encoder_layers=2, ffn_embed_dim=512,
                                              pair_dtype="bfloat16"),
                        chemberta_overrides=dict(num_hidden_layers=1, intermediate_size=512,
                                                 max_position_embeddings=40),
                        use_fds=fds, fds_num=8)
    model.reset_parameters_like_flax(torch.Generator().manual_seed(seed))
    model.to(cuda)
    rng = np.random.RandomState(seed)
    tok = np.full((R, N), GRAPH_PAD, np.int32)
    dist = np.zeros((R, N, N), np.float32)
    edge = np.full((R, N, N), GRAPH_PAD, np.int32)
    ids = np.full((R, L), 1, np.int32)
    mask = np.zeros((R, L), np.int32)
    for r in range(R):
        n, m = rng.randint(4, N + 1), rng.randint(3, L + 1)
        t = rng.randint(4, GRAPH_V, size=n)
        t[0], t[-1] = 0, 2
        tok[r, :n] = t
        c = rng.randn(n, 3).astype(np.float32)
        dist[r, :n, :n] = np.sqrt(((c[:, None] - c[None]) ** 2).sum(-1))
        edge[r, :n, :n] = t[:, None] * GRAPH_V + t[None, :]
        ids[r, :m] = rng.randint(5, 40, size=m)
        ids[r, 0], ids[r, m - 1] = 0, 2
        mask[r, :m] = 1
    feats = {k: _t(v, cuda) for k, v in dict(src_tokens=tok, src_distance=dist,
                                             src_edge_type=edge, input_ids=ids,
                                             attention_mask=mask).items()}
    res = Resident(feats, _t(rng.randn(R, 1).astype(np.float32), cuda),
                   _t(rng.uniform(0.5, 1.5, (R, 1)).astype(np.float32), cuda))
    frozen = frozenset()
    if freeze is not None:
        from mmdti_tpu_torch.train.nnmodel import frozen_parameter_names

        frozen = frozen_parameter_names(model, freeze[0], False, freeze[1])
        for name, p in model.named_parameters():
            p.requires_grad_(name not in frozen)
    opt = FusedAdam(dict(model.named_parameters()), 1e-3, 20, warmup_ratio=0.1, frozen=frozen)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    fds_state = init_fds_state(model.fds_cfg, cuda) if fds else None
    progs = TrainPrograms(model, opt, zoo.mse_loss, "regression", gen, fds_state=fds_state,
                          fds_bucket=(-2.0, 0.5))
    return model, opt, gen, progs, res


def _train_state(opt, progs):
    return [t.clone() for t in (*opt.graph_state, progs.metric_sums)]


def _restore(opt, progs, gen, saved, gen_state):
    for t, s in zip((*opt.graph_state, progs.metric_sums), saved):
        t.copy_(s)
    gen.set_state(gen_state)


def _eager_feed(progs, res, idx):
    return torch.stack([progs.single(*res.take(idx[k])) for k in range(idx.shape[0])])


@pytest.mark.parametrize("ln", ["0", "1"])
@pytest.mark.parametrize("variant", ["feed", "stacked"])
def test_graph_steps_equal_eager_steps(cuda, monkeypatch, ln, variant):
    """K=3 steps replayed from one graph against the same 3 steps run
    eagerly from the same parameters, moments, counts and generator state,
    dropout on: parameters, moments, counts, metrics and the generator's
    offset after are bit-equal; a second replay goes on from there as 3
    more eager steps do."""
    monkeypatch.setenv("MMDTI_PALLAS_LN", ln)
    model, opt, gen, progs, res = _graph_setup(cuda)
    B, K = 8, 3
    idx = torch.arange(2 * K * B, device=cuda).view(2, K, B) % res.labels.shape[0]

    def graph(k_block):
        if variant == "feed":
            return progs.feed(res, k_block)
        steps = [res.take(k_block[k]) for k in range(K)]
        return progs.stacked({n: torch.stack([s[0][n] for s in steps]) for n in steps[0][0]},
                             torch.stack([s[1] for s in steps]),
                             torch.stack([s[2] for s in steps]))

    saved, gen0 = _train_state(opt, progs), gen.get_state()
    m_graph = [graph(idx[0]), graph(idx[1])]
    torch.cuda.synchronize()
    assert len(progs.graphs) == 1
    after_graph, gen_graph = _train_state(opt, progs), gen.get_state()
    _restore(opt, progs, gen, saved, gen0)
    m_eager = [_eager_feed(progs, res, idx[0]), _eager_feed(progs, res, idx[1])]
    torch.cuda.synchronize()
    for a, b in zip(m_graph, m_eager):
        assert torch.equal(a, b)
    for a, b in zip(after_graph, _train_state(opt, progs)):
        assert torch.equal(a, b)
    assert torch.equal(gen_graph, gen.get_state())
    assert opt.state.count == 2 * K
    assert not torch.equal(after_graph[0], saved[0])   # the parameters moved


def test_plain_path_graph_steps_equal_eager_steps(cuda):
    """The plain path records its attention dropout too (the keep mask
    reads the seed on the card): K=3 replayed steps equal 3 eager ones."""
    model, opt, gen, progs, res = _graph_setup(cuda, use_kernels=False)
    idx = torch.arange(24, device=cuda).view(3, 8)
    saved, gen0 = _train_state(opt, progs), gen.get_state()
    m_graph = progs.feed(res, idx)
    torch.cuda.synchronize()
    after_graph, gen_graph = _train_state(opt, progs), gen.get_state()
    _restore(opt, progs, gen, saved, gen0)
    m_eager = _eager_feed(progs, res, idx)
    torch.cuda.synchronize()
    assert len(progs.graphs) == 1 and torch.equal(m_graph, m_eager)
    for a, b in zip(after_graph, _train_state(opt, progs)):
        assert torch.equal(a, b)
    assert torch.equal(gen_graph, gen.get_state())


@pytest.mark.parametrize("ln", ["0", "1"])
def test_remat_steps_equal_steps_without_remat(cuda, monkeypatch, ln):
    """Encoder remat through the kernels, every dropout on: 3 eager steps
    with remat equal 3 without from the same state (parameters, moments,
    counts, metrics, generator), with the pair-bias forward run twice a
    layer; and 3 steps replayed from one graph with remat equal them."""
    import dataclasses

    monkeypatch.setenv("MMDTI_PALLAS_LN", ln)
    model, opt, gen, progs, res = _graph_setup(cuda)
    idx = torch.arange(24, device=cuda).view(3, 8)
    saved, gen0 = _train_state(opt, progs), gen.get_state()
    m_off = _eager_feed(progs, res, idx)
    torch.cuda.synchronize()
    after_off, gen_off = _train_state(opt, progs), gen.get_state()
    _restore(opt, progs, gen, saved, gen0)
    model.encoder.cfg = dataclasses.replace(model.encoder.cfg, remat=True)
    before = ha.pair_bias_attention_cuda.launches
    m_on = _eager_feed(progs, res, idx)
    torch.cuda.synchronize()
    assert ha.pair_bias_attention_cuda.launches - before == 2 * model.unimol_cfg.encoder_layers * 3
    assert torch.equal(m_off, m_on)
    for a, b in zip(after_off, _train_state(opt, progs)):
        assert torch.equal(a, b)
    assert torch.equal(gen_off, gen.get_state())
    _restore(opt, progs, gen, saved, gen0)
    m_graph = progs.feed(res, idx)
    torch.cuda.synchronize()
    assert len(progs.graphs) == 1 and torch.equal(m_graph, m_on)
    for a, b in zip(after_off, _train_state(opt, progs)):
        assert torch.equal(a, b)
    assert torch.equal(gen_off, gen.get_state())


def test_card_remat_rule_reads_the_device_memory(cuda):
    """The card's auto-remat rule compares the predicted peak of a step with
    a share of this device's memory (no 80 GB assumed)."""
    from mmdti_tpu_torch.configs.architectures import UniMolEncoderConfig
    from mmdti_tpu_torch.train import nnmodel

    total = torch.cuda.get_device_properties(cuda).total_memory
    cfg = UniMolEncoderConfig(pair_dtype="bfloat16")
    for b, n in ((32, 64), (32, 280), (256, 280)):
        want = nnmodel.predicted_step_bytes(b, n, 64, cfg) > nnmodel.REMAT_MEMORY_SHARE * total
        assert nnmodel.auto_remat({"pair_dtype": "bfloat16"}, n, 64, b, cuda) is want
    assert not nnmodel.auto_remat({"pair_dtype": "bfloat16"}, 280, 64, 32, cuda)
    assert nnmodel.auto_remat({"pair_dtype": "bfloat16"}, 280, 64, 32, cuda,
                              total_memory=total // 100)


def test_graph_replay_reads_the_fds_state_copied_in(cuda):
    """set_fds_state writes the graph's FDS tensors in place: a replay
    after it equals eager steps on the new state, and differs from eager
    steps on the old one."""
    from mmdti_tpu_torch.losses.fds import init_fds_state

    model, opt, gen, progs, res = _graph_setup(cuda, fds=True)
    idx = torch.arange(16, device=cuda).view(2, 8)
    progs.set_epoch(model.fds_cfg.start_smooth)
    progs.feed(res, idx)                      # records the graph
    old = init_fds_state(model.fds_cfg, cuda)
    draw = torch.Generator(device=cuda).manual_seed(3)
    new = {k: v + 0.5 * torch.rand(v.shape, device=cuda, generator=draw)
           for k, v in old.items()}
    saved, gen0 = _train_state(opt, progs), gen.get_state()
    progs.set_fds_state(new)
    m_graph = progs.feed(res, idx)
    results = {}
    for name, state in (("new", new), ("old", old)):
        _restore(opt, progs, gen, saved, gen0)
        progs.set_fds_state(state)
        results[name] = _eager_feed(progs, res, idx)
    torch.cuda.synchronize()
    assert torch.equal(m_graph, results["new"])
    assert not torch.equal(m_graph, results["old"])


def test_eval_graph_rows_of_a_padded_last_batch(cuda):
    """The sweep's graph over 3 batches of 8 rows, the last holding 5 valid
    rows (its last index repeated): predictions and losses equal the eager
    eval step's on the same rows, and the loss counts the valid rows only."""
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.train.steps import EvalSweep, build_eval_step

    model, _, _, _, res = _graph_setup(cuda)
    rows = np.arange(21)
    idx = np.concatenate([rows, np.repeat(rows[-1:], 3)]).reshape(3, 8)
    idx_d = _t(idx.astype(np.int64), cuda)
    ns = _t(np.asarray([8, 8, 5], np.int64), cuda)
    sweep = EvalSweep(model, zoo.mse_loss, lambda x: x, with_pooled=True)
    preds, losses, pooled, labels = sweep(res, idx_d, ns)
    assert len(sweep.graphs) == 1
    step = build_eval_step(model, zoo.mse_loss, lambda x: x)
    for b in range(3):
        feats, lab, _ = res.take(idx_d[b])
        p, loss, pool, _ = step(feats, lab, int(ns[b]))
        assert torch.equal(preds[b], p) and torch.equal(losses[b], loss)
        assert torch.equal(pooled[b * 8:(b + 1) * 8], pool)
    torch.testing.assert_close(
        losses[2], torch.mean((preds[2, :5].float() - res.labels[16:21]) ** 2),
        atol=1e-6, rtol=1e-5)
    assert torch.equal(labels, res.labels.index_select(0, idx_d.view(-1)).float())


def test_graph_replays_leave_the_layer_norm_tickets_at_zero(cuda, monkeypatch):
    """Five replays of a 2-step graph with the LayerNorm kernels on: every
    backward ticket is 0 afterwards, and the graph launched the LayerNorm
    backward (its scratch exists)."""
    from mmdti_tpu_torch.ops import hopper_ln as hl

    monkeypatch.setenv("MMDTI_PALLAS_LN", "1")
    _, _, _, progs, res = _graph_setup(cuda)
    idx = torch.arange(16, device=cuda).view(2, 8)
    for _ in range(5):
        progs.feed(res, idx)
    torch.cuda.synchronize()
    assert hl._SCRATCH
    assert all(bool((tickets == 0).all()) for _, tickets in hl._SCRATCH.values())


# ---- the LayerNorm kernels as the card's default ------------------------------------

def _flagship_programs(cuda):
    """The flagship MM-DTI (bf16, the kernel path, weights from seed 0) on
    the card, FusedAdam, the train programs (MSE + InfoNCE + CT), a
    generator from seed 0 and chip_smoke's resident batch of 32 molecules
    at N = L = 64."""
    import chip_smoke
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import TrainPrograms

    model = chip_smoke._flagship(True)
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    model.to(cuda)
    opt = FusedAdam(dict(model.named_parameters()), 1e-4, 20, warmup_ratio=0.1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    progs = TrainPrograms(model, opt, zoo.mse_loss, "regression", gen)
    return model, opt, gen, progs, chip_smoke._graph_resident(cuda, 64, 64)


def test_default_flagship_step_runs_every_layer_norm_on_the_kernels(cuda, monkeypatch):
    """MMDTI_PALLAS_LN unset: recording the flagship's train step launches
    the forward and the backward kernel of each of its 49 LayerNorm sites
    once a run (the capture's warm-ups and the recording); the graph is
    keyed as on, and its replays move no counter."""
    import chip_smoke
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP

    monkeypatch.delenv("MMDTI_PALLAS_LN", raising=False)
    model, _, _, progs, res = _flagship_programs(cuda)
    assert chip_smoke._ln_sites(model) == 49
    one = torch.arange(32, device=cuda).view(1, 32)
    chip_smoke._reset_counts()
    progs.feed(res, one)
    torch.cuda.synchronize()
    counts = chip_smoke._read_counts()
    assert counts["layer_norm"] == counts["layer_norm_bwd"] == (GRAPH_WARMUP + 1) * 49
    progs.feed(res, one)
    torch.cuda.synchronize()
    assert chip_smoke._read_counts() == counts
    assert [key[-1] for key in progs.graphs] == [True]


@pytest.mark.parametrize("env,same_as", [(None, "1"), ("0", "plain")])
def test_flagship_step_bit_equal_to_the_path_it_names(cuda, monkeypatch, env, same_as):
    """The flagship's first train step, eagerly (loss and gradients, dropout
    on) and then replayed from its graph from the same state (metrics,
    parameters, moments, counts): MMDTI_PALLAS_LN unset is bit-equal to
    MMDTI_PALLAS_LN=1, and 0 to the plain LayerNorm at every site with
    every other kernel on (the gate patched to plain)."""
    import mmdti_tpu_torch.models.layers as layers
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.train.steps import build_train_loss

    def eager(model, gen, res, rows):
        """The loss and gradients; the autograd graph dies on return (a
        graph left alive keeps accumulators that a capture would wait on)."""
        feats, labels, weights = res.take(rows)
        total, _ = build_train_loss(zoo.mse_loss, "regression")(model, feats, labels, weights,
                                                                 gen)
        grads = torch.autograd.grad(total, list(model.parameters()), allow_unused=True)
        return [total.detach(), *(g for g in grads if g is not None)]

    def step(env, plain=False):
        with monkeypatch.context() as m:
            if env is None:
                m.delenv("MMDTI_PALLAS_LN", raising=False)
            else:
                m.setenv("MMDTI_PALLAS_LN", env)
            if plain:
                m.setattr(layers, "ln_kernel_enabled", lambda *a: False)
            model, opt, gen, progs, res = _flagship_programs(cuda)
            rows = torch.arange(32, device=cuda)
            gen0 = gen.get_state()
            out = eager(model, gen, res, rows)
            torch.cuda.synchronize()
            gen.set_state(gen0)
            metrics = progs.feed(res, rows.view(1, 32))
            torch.cuda.synchronize()
            return [*out, metrics, *_train_state(opt, progs)]

    got = step(env)
    want = step("1") if same_as == "1" else step(None, plain=True)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ln", ["0", "1"])
def test_graph_fit_resumes_from_a_saved_train_state(cuda, monkeypatch, tmp_path, ln):
    """Two K=3 replays uninterrupted, against one replay, the train state
    written to disk (train/checkpointing.py) and read into a new model,
    optimizer and generator whose graph is recorded afresh, then the second
    replay: parameters, moments, counts, metrics and the generator's state
    bit-equal.  The generator's state after K replays equals its state
    after K eager steps from the same start."""
    from mmdti_tpu_torch.train.checkpointing import _host, load_train_state, save_train_state

    monkeypatch.setenv("MMDTI_PALLAS_LN", ln)
    _, opt, gen, progs, res = _graph_setup(cuda)
    B, K = 8, 3
    idx = torch.arange(2 * K * B, device=cuda).view(2, K, B) % res.labels.shape[0]
    saved, gen0 = _train_state(opt, progs), gen.get_state()
    _eager_feed(progs, res, idx[0])
    torch.cuda.synchronize()
    gen_eager = gen.get_state()
    _restore(opt, progs, gen, saved, gen0)
    progs.feed(res, idx[0])
    torch.cuda.synchronize()
    assert torch.equal(gen.get_state(), gen_eager)
    save_train_state(str(tmp_path), 0, {"programs": _host(progs.state_dict())})
    m_whole = progs.feed(res, idx[1])
    torch.cuda.synchronize()
    whole, gen_whole = _train_state(opt, progs), gen.get_state()

    _, opt2, gen2, progs2, res2 = _graph_setup(cuda, seed=1)   # other weights and draws
    progs2.load_state(load_train_state(str(tmp_path), 0)["programs"])
    m_resumed = progs2.feed(res, idx[1])
    torch.cuda.synchronize()
    assert len(progs2.graphs) == 1
    assert torch.equal(m_resumed, m_whole)
    for a, b in zip(whole[:-1], _train_state(opt2, progs2)[:-1]):
        assert torch.equal(a, b)
    assert torch.equal(gen2.get_state(), gen_whole)


def test_cv_fold_reset_replays_the_recorded_graph(cuda):
    """Cross-validation's reuse: after a fold, the parameters copied back
    to their start, the optimizer reset in place and the generator
    reseeded, a replay of the fold's graph on new rows equals the same
    steps on a freshly built model, optimizer, generator and graph."""
    model, opt, gen, progs, res = _graph_setup(cuda)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    B, K = 8, 3
    idx = torch.arange(2 * K * B, device=cuda).view(2, K, B) % res.labels.shape[0]
    progs.feed(res, idx[0])
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(start[k])
    opt.reset()
    gen.manual_seed(0)
    progs.metric_sums.zero_()
    m_reused = progs.feed(res, idx[1])
    torch.cuda.synchronize()
    assert len(progs.graphs) == 1
    _, opt2, gen2, progs2, _ = _graph_setup(cuda)
    m_fresh = progs2.feed(res, idx[1])
    torch.cuda.synchronize()
    assert torch.equal(m_reused, m_fresh)
    for a, b in zip(_train_state(opt, progs), _train_state(opt2, progs2)):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), gen2.get_state())


# ---- data parallelism -----------------------------------------------------------------

def test_nccl_one_rank_graph_fit_equals_the_fit_without_a_group(cuda, tmp_path):
    """MolTrain.fit with the resident feed and 2 steps a CUDA graph, bf16 on
    the kernel path, in a one-rank NCCL group: its train graph records the
    step's collectives (5 a step: the two gathers, their backwards, the
    gradient mean) and the fit is bit-equal to the same fit without a
    group: cv_pred, history and model_0.ckpt's bytes."""
    import json
    import os
    import socket

    import torch.distributed as dist

    from mmdti_tpu_torch import MolTrain
    from mmdti_tpu_torch.data.reader import write_csv
    from mmdti_tpu_torch.parallel.mesh import initialize_distributed

    smiles = ["CCO", "CC(=O)O", "c1ccccc1", "Cc1ccccc1", "CC(C)O", "CCCC", "CCN", "c1ccncc1",
              "CC(=O)Oc1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "C1CCCCC1", "O=C1CCCCC1",
              "CCOC(=O)C", "CCS", "NCCO", "OCC(O)CO", "Clc1ccccc1", "Brc1ccccc1",
              "FC(F)(F)c1ccccc1", "N#Cc1ccccc1"]
    y = np.random.RandomState(0).randn(20) * 2 + 1
    train, val = str(tmp_path / "train.csv"), str(tmp_path / "val.csv")
    write_csv({"smiles": smiles[:16], "y": list(y[:16])}, train)
    write_csv({"smiles": smiles[16:], "y": list(y[16:])}, val)

    def fit(name):
        exp = str(tmp_path / name)
        clf = MolTrain(task="regression", epochs=2, batch_size=8, metrics="mse",
                       smiles_col="smiles", target_cols=["y"], save_path=exp, using_infonce=True,
                       using_ct=True, seed=0, steps_per_call=2, device="cuda",
                       unimol_overrides=dict(encoder_layers=2, ffn_embed_dim=512),
                       chemberta_overrides=dict(num_hidden_layers=1, intermediate_size=512))
        clf.fit(train, val)
        with open(os.path.join(exp, "model_0.ckpt"), "rb") as f:
            ckpt = f.read()
        with open(os.path.join(exp, "history_0.json")) as f:
            hist = [{k: v for k, v in r.items() if "seconds" not in k} for r in json.load(f)]
        (graph,) = clf.trainer._last_programs[2].graphs.values()
        return np.asarray(clf.cv_pred), hist, ckpt, graph.collectives

    plain = fit("no_group")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        group = fit("nccl")
    finally:
        dist.destroy_process_group()
    assert plain[3] == 0 and group[3] == 5 * 2
    assert np.array_equal(plain[0], group[0])
    assert plain[1] == group[1]
    assert plain[2] == group[2]


# ---- pretrained weights and freezing ----------------------------------------------

GRAPH_FREEZE = ("embed_tokens.,gbf.,gbf_proj.,encoder.emb_layer_norm.,encoder.layers_0.", "bert")


def test_bf16_safetensors_weights_land_on_the_card(cuda, tmp_path):
    """A ChemBERTa dir written in bf16 safetensors, read and converted
    (models/hf_weights.py, models/convert.py) into the shallow model, which
    then moves to the card: every ChemBERTa parameter there equals the
    file's bf16 tensor widened to fp32, bit for bit, and a forward on the
    kernel path is finite."""
    import chip_smoke
    from mmdti_tpu_torch.models.convert import load_pretrained
    from mmdti_tpu_torch.models.mm_model import build_model

    written = chip_smoke.write_chemberta_dir(str(tmp_path), 0, layers=1, intermediate=512,
                                             max_positions=40)
    vocab = written["roberta.embeddings.word_embeddings.weight"].shape[0]
    model = build_model(1, GRAPH_V, GRAPH_PAD, vocab, compute_dtype="bfloat16", use_kernels=True,
                        unimol_overrides=dict(encoder_layers=2, ffn_embed_dim=512,
                                              pair_dtype="bfloat16"),
                        chemberta_overrides=dict(num_hidden_layers=1, intermediate_size=512,
                                                 max_position_embeddings=40))
    model.load_state_dict(load_pretrained(dict(model.state_dict()), chemberta_dir=str(tmp_path)))
    model.to(cuda)
    params = dict(model.named_parameters())
    n = 0
    for key, t in written.items():
        name = chip_smoke.roberta_port_name(key)
        if name is not None:
            assert t.dtype == torch.bfloat16
            assert torch.equal(params[name].cpu(), t.float()), name
            n += 1
    assert n == 21
    _, _, _, _, res = _graph_setup(cuda)
    feats, _, _ = res.take(torch.arange(8, device=cuda))
    with torch.no_grad():
        assert torch.isfinite(model(**feats, outputs="logits")["logits"]).all()


@pytest.mark.parametrize("ln", ["0", "1"])
def test_frozen_step_launches_only_the_trainable_backwards(cuda, monkeypatch, ln):
    """The shallow model with its embedding, gbf, gbf_proj, embedding
    LayerNorm, Uni-Mol layer 0 and ChemBERTa frozen: one eager step
    launches every forward kernel (gbf 1, pair-bias 2, masked 3; 13
    LayerNorms with the kernels on) but the backward of the trainable part
    only (gbf 0, pair-bias 1, masked 2: the cross-modal pair; LayerNorm
    13 - 6: the embedding's, layer 0's two and ChemBERTa's three take
    none).  A K=2 graph of the frozen steps replays; the frozen parameters
    stay bit-equal and the others move."""
    import chip_smoke

    monkeypatch.setenv("MMDTI_PALLAS_LN", ln)
    model, opt, gen, progs, res = _graph_setup(cuda, freeze=GRAPH_FREEZE)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    assert "encoder.layers_0.fc1.weight" in opt.frozen and "bert.layer_0.output.weight" in \
        opt.frozen
    chip_smoke._reset_counts()
    progs.single(*res.take(torch.arange(8, device=cuda)))
    torch.cuda.synchronize()
    counts = chip_smoke._read_counts()
    want = {"gbf_proj": 1, "gbf_proj_bwd": 0, "pair_bias_attention": 2,
            "pair_bias_attention_bwd": 1, "masked_attention": 3, "masked_attention_bwd": 2,
            "layer_norm": 13 if ln == "1" else 0, "layer_norm_bwd": 7 if ln == "1" else 0}
    assert counts == want
    progs.feed(res, torch.arange(16, device=cuda).view(2, 8))
    progs.feed(res, torch.arange(16, 32, device=cuda).view(2, 8))
    torch.cuda.synchronize()
    assert len(progs.graphs) == 1
    for name, p in model.named_parameters():
        assert torch.equal(p, start[name]) == (name in opt.frozen), name


# ---- serving: one CUDA graph per shape bucket -------------------------------------

SERVE_CFG = dict(task="regression", compute_dtype="bfloat16",
                 unimol_overrides=dict(encoder_layers=2, ffn_embed_dim=512),
                 chemberta_overrides=dict(num_hidden_layers=1, intermediate_size=512))
SERVE_SMILES = ["CCO", "CC(=O)O", "c1ccccc1", "Cc1ccccc1", "CC(C)O", "CCCC", "CCN",
                "c1ccncc1", "CC(=O)Oc1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"]


def _serve_pair(cuda):
    """The shallow flagship-width model of _graph_setup behind two servers
    on the card: graph-replayed and eager."""
    from mmdti_tpu_torch.api.serve_api import MolServe
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.models.mm_model import build_model

    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    model = build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                        compute_dtype="bfloat16",
                        unimol_overrides=SERVE_CFG["unimol_overrides"],
                        chemberta_overrides=SERVE_CFG["chemberta_overrides"])
    sd = model.reset_parameters_like_flax(torch.Generator().manual_seed(0)).state_dict()
    graph = MolServe.from_state_dict(SERVE_CFG, sd, device=cuda)
    eager = MolServe.from_state_dict(SERVE_CFG, sd, device=cuda)
    eager.use_graphs = False
    return graph, eager


def test_serve_graph_replay_equals_eager(cuda):
    """Each bucket's replayed forward equals the eager forward on the
    card bit for bit; one graph per bucket; replays move no launcher
    counter."""
    graph, eager = _serve_pair(cuda)
    for n in (1, 3, 10):
        want = eager.predict(SERVE_SMILES[:n])["predict"]
        graph.predict(SERVE_SMILES[:n])                       # records
        before = ha.pair_bias_attention_cuda.launches
        got = graph.predict(SERVE_SMILES[:n])["predict"]      # replays
        assert ha.pair_bias_attention_cuda.launches == before
        np.testing.assert_array_equal(got, want)
    assert graph.compiled_shapes == len(graph.graphs) == 3
    cls_g, pooled_g = graph.embed(SERVE_SMILES)
    cls_e, pooled_e = eager.embed(SERVE_SMILES)
    np.testing.assert_array_equal(cls_g, cls_e)
    np.testing.assert_array_equal(pooled_g, pooled_e)


def test_serve_graphs_share_one_pool(cuda):
    """Every bucket's graph records into the server's one pool: buckets
    recorded in one order and replayed in another (each replay reusing
    blocks another graph's capture was handed) all equal the eager
    server."""
    graph, eager = _serve_pair(cuda)
    sizes = (1, 3, 10, 5, 2)
    want = {n: eager.predict(SERVE_SMILES[:n])["predict"] for n in sizes}
    for n in sizes:
        graph.predict(SERVE_SMILES[:n])                       # records
    assert len(graph.graphs) == len(sizes) and graph._pool is not None
    for n in reversed(sizes):
        np.testing.assert_array_equal(graph.predict(SERVE_SMILES[:n])["predict"], want[n])
    for n in sizes:
        np.testing.assert_array_equal(graph.predict(SERVE_SMILES[:n])["predict"], want[n])


def test_serve_two_inflight_batches_of_one_bucket(cuda):
    """Two batches of one bucket dispatched back to back, neither pulled:
    each finalize gets its own rows (a replay writes the graph's static
    outputs, which dispatch cloned)."""
    graph, eager = _serve_pair(cuda)
    a, b = SERVE_SMILES[:4], SERVE_SMILES[4:8]
    graph.predict(a)                                          # records the bucket
    chunks_a, feats_a = graph._dispatch_forward(a)
    chunks_b, feats_b = graph._dispatch_forward(b)
    assert len(graph.graphs) == 1
    out_b = graph._finalize_forward(chunks_b, feats_b, 0.0)["predict"]
    out_a = graph._finalize_forward(chunks_a, feats_a, 0.0)["predict"]
    np.testing.assert_array_equal(out_a, eager.predict(a)["predict"])
    np.testing.assert_array_equal(out_b, eager.predict(b)["predict"])
    assert not np.array_equal(out_a, out_b)


def test_serve_capture_beside_pulls(cuda):
    """Concurrent requests of a warm bucket, pulled outside the server's
    lock, while other requests record cold buckets: every capture
    succeeds and every answer equals the eager server's."""
    import threading

    graph, eager = _serve_pair(cuda)
    warm = SERVE_SMILES[:2]
    want_warm = eager.predict(warm)["predict"]
    graph.predict(warm)
    cold = [SERVE_SMILES[:n] for n in (3, 5, 9, 10)] + [["C" * 30], ["C" * 30] * 3]
    want_cold = [eager.predict(c)["predict"] for c in cold]
    errors, got_cold = [], {}
    stop = threading.Event()

    def pull_warm():
        try:
            while not stop.is_set():
                np.testing.assert_array_equal(graph.predict(warm)["predict"], want_warm)
        except Exception as e:   # surfaced below
            errors.append(e)

    def record_cold():
        try:
            for i, c in enumerate(cold):
                got_cold[i] = graph.predict(c)["predict"]
        except Exception as e:
            errors.append(e)

    pullers = [threading.Thread(target=pull_warm) for _ in range(3)]
    for t in pullers:
        t.start()
    recorder = threading.Thread(target=record_cold)
    recorder.start()
    recorder.join(timeout=300)
    stop.set()
    for t in pullers:
        t.join(timeout=60)
    assert not recorder.is_alive() and not any(t.is_alive() for t in pullers)
    assert not errors, errors
    assert len(graph.graphs) == 1 + len(cold)
    for i, want in enumerate(want_cold):
        np.testing.assert_array_equal(got_cold[i], want)


def test_serve_capture_and_pull_wait_for_each_other(cuda):
    """chip_smoke.py's check, on the shallow model: a pull asked for during
    a capture takes the pull gate only after it, and a capture asked for
    while a pull waits on the device only after the pull; every row right."""
    import chip_smoke

    graph, _ = _serve_pair(cuda)
    seen = chip_smoke._capture_beside_pulls(graph, SERVE_SMILES[:2],
                                            (["C" * 30] * 2, ["C" * 30] * 3))
    assert seen["rows_right"] and seen["pull_took_gate_after_capture"]
    assert seen["capture_took_gate_after_pull"]


def test_embed_backward_repeats_bit_equal_past_3072_indices(cuda):
    """MOF's 16 x 528 atom tokens: the table's gradient (a one-hot GEMM)
    is the same bit for bit on every call, and equals PyTorch's scatter
    within fp32 rounding."""
    from mmdti_tpu_torch.models.layers import Embed

    gen = torch.Generator(device=cuda).manual_seed(0)
    emb = Embed(31, 512).to(cuda)
    ids = torch.randint(0, 31, (16, 528), device=cuda, generator=gen)
    g = torch.randn(16, 528, 512, device=cuda, generator=gen)
    grads = [torch.autograd.grad((emb(ids) * g).sum(), emb.weight)[0] for _ in range(3)]
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    want = torch.autograd.grad((torch.nn.functional.embedding(ids, emb.weight) * g).sum(),
                               emb.weight)[0]
    torch.testing.assert_close(grads[0], want, atol=1e-3, rtol=1e-5)


def _refine_group(smis, dev):
    from mmdti_tpu_torch.chem import device_conformer as dc

    items = [(i, dc._prepare(s, 42)) for i, s in enumerate(smis)]
    bucket = dc._atom_bucket(max(len(it[0]) for _, it in items))
    arrays = dc.DeviceConformerBatcher(device=dev).group_arrays(bucket, items)
    return [torch.from_numpy(a).to(dev) for a in arrays], items


def test_device_refine_graph_equals_eager_and_repeats(cuda):
    """The recorded 300-iteration refinement against eager refinement on the
    card: replays bit-equal to each other and to an eager run (or as close
    as two eager runs), whatever the TF32 setting, a molecule alone against
    co-batched within 1e-5, and the group against the CPU within 1e-3."""
    from mmdti_tpu_torch.ops import device_refine as dr

    smis = ["C" * 40, "CC(C)Cc1ccc(cc1)C(C)C(=O)O" * 3, "c1ccccc1" * 6 + "CCN"]
    inputs, items = _refine_group(smis, cuda)
    eager = [dr.refine_conformers(*inputs, use_graph=False) for _ in range(2)]
    graph = [dr.refine_conformers(*inputs) for _ in range(2)]
    assert torch.equal(graph[0], graph[1])
    gap = (eager[0] - eager[1]).abs().max().item()
    assert (graph[0] - eager[0]).abs().max().item() <= gap
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(dr.refine_conformers(*inputs), graph[0])
        assert (dr.refine_conformers(*inputs, use_graph=False) - eager[0]).abs().max() <= gap
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    alone, _ = _refine_group(smis[:1], cuda)
    n = len(items[0][1][0])
    torch.testing.assert_close(dr.refine_conformers(*alone)[0, :n], graph[0][0, :n],
                               atol=1e-5, rtol=0)
    cpu = dr.refine_conformers(*[t.cpu() for t in inputs])
    for r, (_, item) in enumerate(items):
        k = len(item[0])
        torch.testing.assert_close(graph[0][r, :k].cpu(), cpu[r, :k], atol=1e-3, rtol=0)


def test_device_refinement_does_not_wait_for_the_callers_stream(cuda):
    """A warm featurization's copies, replays and pull run on the
    refinement stream: with the default stream busy (a sleep kernel, as a
    server's forward in flight), the coordinates come back before it ends,
    bit-equal to those of an idle card."""
    from mmdti_tpu_torch.chem import device_conformer as dc

    smis = ["C" * 40, "CC(C)Cc1ccc(cc1)C(C)C(=O)O" * 3]
    want = dc.device_smi2coords_batch(smis, min_atoms=0, device=cuda)   # records
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))
    got = dc.device_smi2coords_batch(smis, min_atoms=0, device=cuda)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy
    for (a_atoms, a), (b_atoms, b) in zip(got, want):
        assert a_atoms == b_atoms
        np.testing.assert_array_equal(a, b)


def test_stream_put_prefetches_on_a_side_stream(cuda):
    """The fit's host branch feed: batches copied from pinned memory on a
    side stream two ahead arrive whole on the consumer's stream."""
    from mmdti_tpu_torch.data.pipeline import StreamPut, prefetch_to_device

    rng = np.random.RandomState(0)
    batches = [({"src_tokens": rng.randint(0, 30, (32, 208)).astype(np.int32)},
                rng.randn(32, 1).astype(np.float32), None) for _ in range(6)]
    put = StreamPut(cuda)
    assert put.stream != torch.cuda.current_stream()
    for staged, (feats, labels, _) in zip(prefetch_to_device(batches, put), batches):
        got_feats, got_labels, got_weights = staged.take()
        assert got_weights is None and got_labels.device.type == "cuda"
        assert torch.equal(got_feats["src_tokens"].cpu(), torch.from_numpy(feats["src_tokens"]))
        assert torch.equal(got_labels.cpu(), torch.from_numpy(labels))


def _docking_setup(cuda, layers=2, decoder_layers=2, seed=5):
    """A small bf16 docking model on the kernel path, dropout on, with its
    optimizer, generator, TrainPrograms and 16 resident complexes."""
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.models.docking import build_docking_model
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import Resident, TrainPrograms

    u = dict(encoder_layers=layers, embed_dim=128, ffn_embed_dim=256, attention_heads=16,
             gaussian_kernels=128, pair_dtype="bfloat16")
    model = build_docking_model(12, 1, 10, 1, "bfloat16", True, u, None, decoder_layers, 3)
    model.reset_parameters_like_flax(torch.Generator().manual_seed(seed))
    model.to(cuda)
    rng = np.random.RandomState(seed)
    R, Nm, Np = 16, 16, 40
    lt, pt = np.ones((R, Nm), np.int64), np.ones((R, Np), np.int64)
    lc, pc = rng.randn(R, Nm, 3).astype(np.float32), rng.randn(R, Np, 3).astype(np.float32) * 4
    labels = np.zeros((R, Nm, Np + Nm), np.float32)
    for r in range(R):
        n, p = rng.randint(4, Nm - 1), rng.randint(10, Np - 1)
        lt[r, 0], lt[r, 1:n + 1], lt[r, n + 1] = 0, rng.randint(4, 11, n), 2
        pt[r, 0], pt[r, 1:p + 1], pt[r, p + 1] = 0, rng.randint(4, 9, p), 2
        labels[r, 1:n + 1, 1:p + 1] = rng.uniform(2, 12, (n, p))
        labels[r, 1:n + 1, Np + 1:Np + n + 1] = rng.uniform(1, 6, (n, n))
    feats = {k: _t(v, cuda) for k, v in dict(src_tokens=lt, src_coord=lc, pocket_src_tokens=pt,
                                             pocket_src_coord=pc).items()}
    res = Resident(feats, _t(labels, cuda), None)
    opt = FusedAdam(dict(model.named_parameters()), 1e-3, 20, warmup_ratio=0.1)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    progs = TrainPrograms(model, opt, zoo.docking_pose_loss, "docking", gen, use_infonce=False,
                          use_ct=False, use_weight=False)
    return model, opt, gen, progs, res


def test_docking_graph_steps_equal_eager_steps(cuda):
    """Two docking steps replayed from one graph (dropout on, bf16 kernels)
    against the same two steps run eagerly from the same state: metrics,
    parameters, moments, counts and the generator are bit-equal."""
    model, opt, gen, progs, res = _docking_setup(cuda)
    idx = torch.arange(8, device=cuda).view(2, 4)
    saved, gen0 = _train_state(opt, progs), gen.get_state()
    m_graph = progs.feed(res, idx)
    torch.cuda.synchronize()
    after_graph, gen_graph = _train_state(opt, progs), gen.get_state()
    _restore(opt, progs, gen, saved, gen0)
    m_eager = _eager_feed(progs, res, idx)
    torch.cuda.synchronize()
    assert len(progs.graphs) == 1 and torch.isfinite(m_graph).all()
    assert torch.equal(m_graph, m_eager)
    for a, b in zip(after_graph, _train_state(opt, progs)):
        assert torch.equal(a, b)
    assert torch.equal(gen_graph, gen.get_state())
    assert not torch.equal(after_graph[0], saved[0])


def test_docking_step_launches_at_capture(cuda):
    """At the published depths (15 + 15 encoder layers, 4 decoder layers x
    3 rounds) a captured docking step launches, per step, 42 pair-bias
    forwards and 42 backwards, 2 gbf forwards and 2 backwards, every one on
    the bf16 "mma" route of the pair-bias kernels."""
    from mmdti_tpu_torch.train.steps import GRAPH_WARMUP

    model, opt, gen, progs, res = _docking_setup(cuda, layers=15, decoder_layers=4)
    counters = (ha.pair_bias_attention_cuda, ha.pair_bias_attention_bwd_cuda,
                hg.gbf_pair_bias_cuda, hg.gbf_pair_bias_bwd_cuda)
    before = [c.launches for c in counters]
    mma = [c.routes["mma"] for c in counters[:2]]
    progs.feed(res, torch.arange(4, device=cuda).view(1, 4))
    torch.cuda.synchronize()
    runs = GRAPH_WARMUP + 1
    assert [c.launches - b for c, b in zip(counters, before)] == [42 * runs, 42 * runs,
                                                                  2 * runs, 2 * runs]
    assert [c.routes["mma"] - b for c, b in zip(counters[:2], mma)] == [42 * runs] * 2
