"""Attention dropout of mmdti_tpu_torch: the keep mask is a pure function of
(seed, b, h, i, j), its keep rate is 1 - rate, and the backward replays the
forward's mask.  The TPU kernels draw from the on-core PRNG, so no test can
hold the port's bits against JAX's; these properties are what both share
(tests/test_pallas.py::TestPallasDropout checks the same identity there).
"""

import numpy as np
import pytest
import torch

from mmdti_tpu_torch.ops import attention as tatt
from mmdti_tpu_torch.ops import dropout as drop
from mmdti_tpu_torch.ops import hopper_attention as ha


def _fmix32_int(x: int) -> int:
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & m
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & m
    return x ^ (x >> 16)


def test_keep_mask_equals_exact_32bit_arithmetic():
    """The int64 16-bit-half multiplies equal exact uint32 arithmetic (the
    CUDA kernels' dropout.cuh) at sampled coordinates."""
    seed, rate, B, H, Nq, Nk = -123456789, 0.3, 3, 5, 7, 11
    mask = drop.keep_mask(seed, rate, B, H, Nq, Nk)
    rng = np.random.RandomState(0)
    for _ in range(200):
        b, h, i, j = (int(rng.randint(n)) for n in (B, H, Nq, Nk))
        key = _fmix32_int((seed & 0xFFFFFFFF) ^ _fmix32_int((b * H + h + 0x9E3779B9) & 0xFFFFFFFF))
        bits = _fmix32_int(key ^ _fmix32_int((i * Nk + j + 0x7F4A7C15) & 0xFFFFFFFF))
        assert bool(mask[b, h, i, j]) == (bits >= drop.threshold(rate))


def test_keep_mask_depends_only_on_coordinates():
    """Evaluated head by head, or in uneven chunks, the mask is the same."""
    seed, rate, B, H, Nq, Nk = 77, 0.25, 2, 6, 9, 13
    whole = drop.keep_mask(seed, rate, B, H, Nq, Nk)
    chunks = [drop.keep_mask(seed, rate, B, H, Nq, Nk, heads=slice(a, b))
              for a, b in ((0, 1), (1, 4), (4, 6))]
    assert torch.equal(torch.cat(chunks, dim=1), whole)
    assert not torch.equal(drop.keep_mask(seed + 1, rate, B, H, Nq, Nk), whole)


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_rate_within_four_sigma(rate):
    mask = drop.keep_mask(2024, rate, 4, 4, 256, 256)
    n = mask.numel()
    assert n >= 1_000_000
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(mask.float().mean().item() - (1 - rate)) < 4 * sigma


def _replay_inputs(Nq=16, Nk=16, H=2, D=8, seed=3):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(1, Nq, H * D).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(1, Nk, H * D).astype(np.float32)) for _ in range(2))
    return q, k, v, rng


@pytest.mark.parametrize("kind", ["pair_bias", "masked"])
def test_backward_replays_forward_mask(kind):
    """out is linear in v, so <f(v), g> == <v, J^T g> holds only if the
    backward drops what the forward dropped (rate 0.25, rtol 1e-4, as
    tests/test_pallas.py:249)."""
    H, rate = 2, 0.25
    q, k, v, rng = _replay_inputs(H=H)
    seed = torch.tensor([5], dtype=torch.int32)
    v = v.requires_grad_()
    kw = dict(num_heads=H, dropout_rate=rate, seed=seed, deterministic=False)
    if kind == "pair_bias":
        bias = torch.from_numpy(rng.randn(1, H, 16, 16).astype(np.float32))
        out, _ = ha.pair_bias_attention_fused(q, k, v, bias, **kw)
    else:
        out = ha.masked_attention_fused(q, k, v, torch.zeros(1, 16), **kw)
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    (dv,) = torch.autograd.grad((out * g).sum(), v)
    np.testing.assert_allclose(float((out * g).sum().detach()), float((v.detach() * dv).sum()),
                               rtol=1e-4)


def test_oracle_path_drops_what_the_kernel_path_drops():
    """use_kernels=False applies the same keep mask for the same seed."""
    H, rate = 2, 0.3
    q, k, v, rng = _replay_inputs(Nq=8, Nk=12, H=H, seed=4)
    mask = torch.zeros(1, 12)
    seed = torch.tensor([99], dtype=torch.int32)
    kw = dict(num_heads=H, dropout_rate=rate, seed=seed, deterministic=False)
    got = tatt.masked_attention(q, k, v, mask, use_kernels=True, **kw)
    want = tatt.masked_attention(q, k, v, mask, use_kernels=False, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert not torch.allclose(got, tatt.masked_attention(q, k, v, mask, num_heads=H), atol=1e-3)


def test_dropout_without_a_seed_raises():
    q, k, v, _ = _replay_inputs(Nq=8, Nk=8)
    with pytest.raises(ValueError, match="seed"):
        ha.masked_attention_fused(q, k, v, torch.zeros(1, 8), num_heads=2, dropout_rate=0.1,
                                  deterministic=False)
