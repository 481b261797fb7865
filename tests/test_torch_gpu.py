"""mmdti_tpu_torch Hopper kernels against their plain PyTorch versions on a
CUDA card.  Imports neither JAX nor the JAX package, so it runs on a machine
that has only torch and the CUDA toolkit:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test here skips.  Tolerances: fp32 atol 1e-4
(TF32 off; the sums run in another order); bf16 atol 2e-2 on outputs and
rtol 1e-2 / atol 5e-2 on the stored logits, as tests/test_pallas.py:69-73.
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
