"""The bf16 ("mma") route of masked attention on the CPU: the plain versions
of the tensor-core kernels against the JAX package, and an emulation of the
kernels' tile schedule against the whole-row plain forward.

* The plain forward returns (out, stats) and the plain backward starts from
  them; both are held to the Pallas kernel run in interpret mode and its
  jax.vjp (as tests/test_torch_backward.py does), in fp32: attention atol
  1e-5, gradients atol 1e-4 (tests/test_pallas.py:51,100).
* The stats-based backward equals the recompute-everything oracle
  (masked_attention_bwd_plain) with dropout on.
* ``_tiled_forward`` below repeats, in PyTorch, what
  csrc/masked_attention.cu's forward does per row: an online max and sum
  over 64-key tiles, keys past Nk at -inf, each probability summed before
  dropout zeroes it, the fully-masked-row guard applied to the running max.
  It must equal the whole-row plain forward (atol 1e-5 on out, stats to
  fp32 rounding).
The kernels themselves run only on a CUDA card (tests/test_torch_gpu.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmdti_tpu.ops.pallas_attention as pa
from mmdti_tpu_torch.ops import dropout as drop
from mmdti_tpu_torch.ops import hopper_attention as ha

ATT_ATOL = 1e-5
GRAD_ATOL = 1e-4
FMIN = float(np.finfo(np.float32).min)
TILE = 64  # keys per tile in the kernels


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pa.pl, "pallas_call",
                        functools.partial(pa.pl.pallas_call, interpret=True))


def _tt(a):
    return torch.from_numpy(np.array(a))


def _case(B, H, Nq, Nk, D, fill, masked_rows=(), seed=0):
    """q, k, v, g_out and an additive key mask: batch row 0 masks its last
    5 keys, each batch row in masked_rows masks every key."""
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(B, Nq, H * D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, Nk, H * D).astype(np.float32) for _ in range(2))
    mask = np.zeros((B, Nk), np.float32)
    mask[0, max(0, Nk - 5):] = fill
    for b in masked_rows:
        mask[b, :] = fill
    return q, k, v, mask, g


PALLAS_CASES = {  # name -> (H, Nq, Nk, D, fill, fully masked batch rows)
    "nq_ne_nk_minus_1e4": (4, 16, 24, 8, -10000.0, ()),
    "finfo_min": (2, 16, 16, 16, FMIN, ()),
    "finfo_min_fully_masked_row": (4, 8, 24, 8, FMIN, (1,)),
    "neg_inf_fully_masked_row": (2, 16, 32, 16, -np.inf, (1,)),
}


@pytest.mark.parametrize("name", list(PALLAS_CASES))
def test_stats_plain_matches_pallas_forward_and_vjp(interpret_mode, name):
    H, Nq, Nk, D, fill, rows = PALLAS_CASES[name]
    q, k, v, mask, g = _case(2, H, Nq, Nk, D, fill, rows)
    want_out, vjp = jax.vjp(
        lambda q, k, v: pa.masked_attention_pallas(q, k, v, jnp.asarray(mask)[:, None, :],
                                                   num_heads=H),
        *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))

    out, stats = ha.masked_attention_plain(_tt(q), _tt(k), _tt(v), _tt(mask), H)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATT_ATOL)
    assert stats.shape == (2, H, Nq, 2) and torch.isfinite(stats).all()
    if rows and fill == -np.inf:
        np.testing.assert_array_equal(out.numpy()[1], 0.0)   # the guard: out 0
        np.testing.assert_array_equal(stats.numpy()[1, ..., 0], 0.0)
    got = ha.masked_attention_stats_bwd_plain(_tt(q), _tt(k), _tt(v), _tt(mask), out, stats,
                                              _tt(g), H)
    for name_, a, b in zip("qkv", got, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=f"d{name_}")


@pytest.mark.parametrize("fill", [-10000.0, FMIN])
def test_stats_backward_equals_recompute_oracle_with_dropout(fill):
    H, rate = 4, 0.2
    q, k, v, mask, g = (_tt(a) for a in _case(2, H, 12, 20, 8, fill, (1,), seed=2))
    seed = torch.tensor([4242], dtype=torch.int32)
    out, stats = ha.masked_attention_plain(q, k, v, mask, H, seed, rate)
    got = ha.masked_attention_stats_bwd_plain(q, k, v, mask, out, stats, g, H, seed, rate)
    want = ha.masked_attention_bwd_plain(q, k, v, mask, g, H, seed, rate)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


def test_cpu_bf16_takes_the_stats_route_and_counts_no_launch():
    """bf16 CPU tensors run the "mma" route's plain versions through the
    differentiable op; its gradients are the stats backward's."""
    H = 2
    q, k, v, mask, g = (_tt(a) for a in _case(2, H, 8, 12, 16, -10000.0))
    q, k, v, g = (t.to(torch.bfloat16) for t in (q, k, v, g))
    counters = (ha.masked_attention_cuda, ha.masked_attention_bwd_cuda)
    before = [(c.launches, dict(c.routes)) for c in counters]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ha.masked_attention_fused(*leaves, mask, num_heads=H)
    grads = torch.autograd.grad(out, leaves, g)
    want_out, stats = ha.masked_attention_plain(q, k, v, mask, H)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want_out)
    for a, b in zip(grads, ha.masked_attention_stats_bwd_plain(q, k, v, mask, want_out, stats,
                                                                g, H)):
        assert torch.equal(a, b)
    assert [(c.launches, dict(c.routes)) for c in counters] == before
    assert ha.masked_route(torch.bfloat16) == "mma"
    assert ha.masked_route(torch.float32) == "rows"
    with pytest.raises(TypeError):
        ha.masked_route(torch.float16)


# ---------------------------------------------------------------------------
# the kernel's tile schedule, emulated
# ---------------------------------------------------------------------------


def _tiled_forward(logits, vh, keep=None, rate=0.0):
    """The forward kernel's per-row schedule on fp32 logits [B,H,Nq,Nk] and
    v [B,H,Nk,D] -> (out [B,H,Nq,D], stats [B,H,Nq,2])."""
    B, H, Nq, Nk = logits.shape
    n_tiles = -(-Nk // TILE)
    pad = n_tiles * TILE - Nk
    s_all = torch.nn.functional.pad(logits, (0, pad), value=-float("inf"))  # tail keys
    v_all = torch.nn.functional.pad(vh, (0, 0, 0, pad))                     # zero-filled
    k_all = None if keep is None else torch.nn.functional.pad(keep, (0, pad), value=False)
    m_run = torch.full((B, H, Nq, 1), -float("inf"))
    l_run = torch.zeros((B, H, Nq, 1))
    o = torch.zeros((B, H, Nq, vh.shape[-1]))
    for t in range(n_tiles):
        cols = slice(t * TILE, (t + 1) * TILE)
        s = s_all[..., cols]
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        alpha = torch.where(m_run == -float("inf"), torch.zeros(()), torch.exp(m_run - m_new))
        m_use = torch.where(torch.isfinite(m_new), m_new, torch.zeros(()))  # guard
        m_run = m_new
        p = torch.exp(s - m_use)
        l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)   # summed before dropout
        if k_all is not None:
            p = torch.where(k_all[..., cols], p, torch.zeros(()))
        o = o * alpha + torch.matmul(p, v_all[..., cols, :])
    inv = 1.0 / l_run.clamp_min(1e-30)
    scale = inv * drop.keep_scale(rate) if keep is not None else inv
    m_fin = torch.where(torch.isfinite(m_run), m_run, torch.zeros(()))
    return o * scale, torch.cat([m_fin, inv], dim=-1)


TILE_CASES = {  # name -> (Nk, fill, key mask edits)
    "nk_1": (1, -10000.0, None),
    "nk_63": (63, FMIN, None),
    "nk_65": (65, -10000.0, None),
    "nk_130": (130, FMIN, None),
    "first_tile_all_neg_inf": (130, -np.inf, "first_tile"),
    "fully_masked_neg_inf": (65, -np.inf, "all"),
    "fully_masked_finfo_min": (130, FMIN, "all"),
}


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("name", list(TILE_CASES))
def test_tile_schedule_equals_whole_row_forward(name, rate):
    Nk, fill, edit = TILE_CASES[name]
    B, H, Nq, D = 2, 2, 5, 16
    q, k, v, mask, _ = _case(B, H, Nq, Nk, D, fill, seed=7)
    if edit == "first_tile":
        mask[1, :TILE] = fill
    elif edit == "all":
        mask[1, :] = fill
    q, k, v, mask = (_tt(a) for a in (q, k, v, mask))
    seed = torch.tensor([99], dtype=torch.int32) if rate else None
    want_out, want_stats = ha.masked_attention_plain(q, k, v, mask, H, seed, rate)

    qh, kh, vh = (ha.split_heads(t, H) for t in (q, k, v))
    logits = ha._masked_logits(qh, kh, mask, D)
    keep = ha.keep_mask_for(seed, rate, B, H, Nq, Nk, None)
    out, stats = _tiled_forward(logits, vh, keep, rate)
    torch.testing.assert_close(ha.merge_heads(out), want_out, atol=ATT_ATOL, rtol=0)
    torch.testing.assert_close(stats, want_stats, atol=0, rtol=1e-5)
    if edit == "all" and fill == -np.inf:
        assert torch.equal(want_out[1], torch.zeros_like(want_out[1]))
    if edit == "all" and fill == FMIN and rate == 0.0:   # a finfo.min row averages V
        torch.testing.assert_close(want_out[1], v[1].mean(dim=0).expand(Nq, -1),
                                   atol=ATT_ATOL, rtol=0)
