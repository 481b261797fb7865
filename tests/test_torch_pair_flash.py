"""The bf16 ("mma") route of pair-bias attention on the CPU: the plain
versions of the tensor-core kernels against the JAX package, and an
emulation of the kernels' tile schedules against the whole-row plain
versions.

* The plain forward returns (out, logits, stats) and the stats backward
  starts from them; both are held to the Pallas kernel run in interpret
  mode and its jax.vjp (as tests/test_torch_backward.py does), in fp32:
  attention atol 1e-5, gradients atol 1e-4 (tests/test_pallas.py:51,100).
* The stats backward equals the recompute-everything oracle
  (pair_bias_attention_bwd_plain) with dropout on, at atol 1e-4.
* ``_tiled_forward`` repeats, in PyTorch, what the forward kernel of
  csrc/pair_bias_attention.cu does per row: an online max and sum over
  64-key tiles, keys past N at -inf, each probability summed before dropout
  drops it, the fully-masked-row guard on the running max, and the second
  row sum over the stored logits that the stats carry.  ``_tiled_backward``
  repeats the backward kernel's schedule: 64-key tiles, 64-row query tiles
  inside them, dq's running sum over the key tiles in 32-key steps, each
  warp's 16 keys of a tile summing dk and dv over the query tiles in order
  and written when the key tile ends, r = rowsum(g_out * out), every dbias
  entry written once.  Both must equal the whole-row plain versions
  to fp32 rounding (atol 1e-5; the sums only run in another order).
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
TILE_ATOL = 1e-5
TILE = 64   # query rows and keys per tile in the kernels
WARPS = 4   # 16 rows (or keys) a warp
STEP = 32   # keys per dq step of the backward
NEG_INF = -float("inf")


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pa.pl, "pallas_call",
                        functools.partial(pa.pl.pallas_call, interpret=True))


def _tt(a):
    return torch.from_numpy(np.array(a))


def _case(B, H, N, D, seed=0, masked_row=True, first_tile=False):
    """q, k, v, g_out, bias and g_logits as numpy fp32: batch row 1 pads its
    last 5 keys (-inf bias); with masked_row, query row 2 of batch row 0
    sees no key at all; with first_tile, query row 0 of batch row 1 has an
    all -inf first tile of 64 keys.  g_logits is 0 where the bias is -inf
    (the loss reads only finite logits)."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, N, H * D).astype(np.float32) for _ in range(4))
    bias = rng.randn(B, H, N, N).astype(np.float32)
    bias[1, :, :, max(0, N - 5):] = -np.inf
    if masked_row and N > 2:
        bias[0, :, 2, :] = -np.inf
    if first_tile:
        bias[1, :, 0, :TILE] = -np.inf
    g_logits = np.where(np.isfinite(bias), rng.randn(B, H, N, N), 0.0).astype(np.float32)
    return q, k, v, g, bias, g_logits


PALLAS_CASES = {  # name -> (N, g_out present, g_logits present, fully masked row)
    "g_logits": (16, True, True, False),
    "no_g_logits": (16, True, False, False),
    "no_g_out": (16, False, True, False),
    "fully_masked_row": (24, True, True, True),
}


@pytest.mark.parametrize("name", list(PALLAS_CASES))
def test_stats_plain_matches_pallas_forward_and_vjp(interpret_mode, name):
    N, with_g, with_gl, masked_row = PALLAS_CASES[name]
    H, D = 2, 8
    q, k, v, g, bias, g_logits = _case(2, H, N, D, masked_row=masked_row)
    (want_out, want_logits), vjp = jax.vjp(
        lambda *a: pa.pair_bias_attention_pallas(*a, num_heads=H),
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    want = vjp((jnp.asarray(g if with_g else np.zeros_like(g)),
                jnp.asarray(g_logits if with_gl else np.zeros_like(g_logits))))

    out, logits, stats = ha.pair_bias_attention_plain(_tt(q), _tt(k), _tt(v), _tt(bias),
                                                            H)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATT_ATOL)
    want_logits = np.asarray(want_logits)
    assert np.array_equal(np.isneginf(logits.numpy()), np.isneginf(want_logits))
    fin = np.isfinite(want_logits)
    np.testing.assert_allclose(logits.numpy()[fin], want_logits[fin], atol=ATT_ATOL)
    assert stats.shape == (2, H, N, 2) and torch.isfinite(stats).all()
    if masked_row:   # the guard: out 0, the max 0
        np.testing.assert_array_equal(out.numpy()[0, 2], 0.0)
        np.testing.assert_array_equal(stats.numpy()[0, :, 2, 0], 0.0)
    got = ha.pair_bias_attention_stats_bwd_plain(
        _tt(q), _tt(k), _tt(v), logits, out, stats, _tt(g) if with_g else None,
        _tt(g_logits) if with_gl else None, H)
    for n, a, b in zip(("q", "k", "v", "bias"), got, want):
        b = np.asarray(b)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a.numpy()[fin], b[fin], atol=GRAD_ATOL, err_msg=f"d{n}")


@pytest.mark.parametrize("with_g,with_gl", [(True, True), (True, False), (False, True)])
def test_stats_backward_equals_recompute_oracle_with_dropout(with_g, with_gl):
    H, rate = 2, 0.2
    q, k, v, g, bias, g_logits = (_tt(a) for a in _case(2, H, 20, 8, seed=2))
    seed = torch.tensor([4242], dtype=torch.int32)
    out, logits, stats = ha.pair_bias_attention_plain(q, k, v, bias, H, torch.float32,
                                                            seed, rate)
    g, g_logits = (g if with_g else None), (g_logits if with_gl else None)
    got = ha.pair_bias_attention_stats_bwd_plain(q, k, v, logits, out, stats, g, g_logits, H,
                                                 seed, rate)
    want = ha.pair_bias_attention_bwd_plain(q, k, v, logits, g, g_logits, H, seed, rate)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


def test_stats_of_bf16_logits_normalise_the_stored_logits():
    """With a bf16 pair the stats' 1/rowsum is taken over the rounded
    logits, so exp(stored - m) * inv sums to 1 over every row that sees a
    key, and the max is that of the fp32 logits."""
    H = 2
    q, k, v, _, bias, _ = (_tt(a) for a in _case(2, H, 20, 8, seed=3))
    out, stored, stats = ha.pair_bias_attention_plain(q, k, v, bias, H, torch.bfloat16)
    out32, logits32, _ = ha.pair_bias_attention_plain(q, k, v, bias, H)
    assert stored.dtype == torch.bfloat16 and torch.equal(stored, logits32.to(torch.bfloat16))
    assert torch.equal(out, out32)
    p = torch.exp(stored.float() - stats[..., :1]) * stats[..., 1:]
    sums = p.sum(dim=-1)
    seen = torch.isfinite(stored.float()).any(dim=-1)
    torch.testing.assert_close(sums[seen], torch.ones_like(sums[seen]), atol=1e-6, rtol=0)
    assert torch.equal(sums[~seen], torch.zeros_like(sums[~seen]))
    torch.testing.assert_close(stats[..., 0], ha.guarded_max(logits32)[..., 0], atol=0, rtol=0)


def test_cpu_bf16_takes_the_stats_route_and_counts_no_launch():
    """bf16 CPU tensors with a bf16 pair run the "mma" route's plain
    versions through the differentiable op; its gradients are the stats
    backward's."""
    H = 2
    q, k, v, g, bias, g_logits = (_tt(a) for a in _case(2, H, 12, 8, seed=4))
    q, k, v, g = (t.to(torch.bfloat16) for t in (q, k, v, g))
    counters = (ha.pair_bias_attention_cuda, ha.pair_bias_attention_bwd_cuda)
    before = [(c.launches, dict(c.routes)) for c in counters]
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias.to(torch.bfloat16))]
    out, logits = ha.pair_bias_attention_fused(*leaves, num_heads=H, pair_dtype=torch.bfloat16)
    grads = torch.autograd.grad((out, logits), leaves, (g, g_logits.to(torch.bfloat16)))
    want_out, want_logits, stats = ha.pair_bias_attention_plain(
        q, k, v, bias.to(torch.bfloat16), H, torch.bfloat16)
    assert out.dtype == logits.dtype == torch.bfloat16
    assert torch.equal(out, want_out) and torch.equal(logits, want_logits)
    want = ha.pair_bias_attention_stats_bwd_plain(q, k, v, want_logits, want_out, stats, g,
                                                  g_logits.to(torch.bfloat16), H)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    assert [(c.launches, dict(c.routes)) for c in counters] == before


def test_pair_bias_route_is_chosen_by_dtype():
    bf, f32 = torch.bfloat16, torch.float32
    assert ha.pair_bias_route(bf, bf) == "mma"
    assert ha.pair_bias_route(bf, f32) == "rows"
    assert ha.pair_bias_route(f32, bf) == "rows"
    assert ha.pair_bias_route(f32, f32) == "rows"
    with pytest.raises(TypeError):
        ha.pair_bias_route(torch.float16, bf)
    with pytest.raises(TypeError):
        ha.pair_bias_route(bf, torch.float16)


@pytest.mark.parametrize("N,D,ok", [(280, 8, True), (3840, 8, True), (3841, 8, False),
                                    (1920, 16, True), (448, 64, True), (449, 64, False)])
def test_bf16_backward_shape_limit(N, D, ok):
    """dq and the row stats of every row sit in shared memory: 33,536 bytes
    at N=64, D=8 (one stage buffer) and 75,520 at N=280."""
    assert ha.pair_mma_backward_smem(64, 8) == 33536
    assert ha.pair_mma_backward_smem(280, 8) == 75520
    if ok:
        ha.check_pair_mma_backward(N, D)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            ha.check_pair_mma_backward(N, D)


# ---------------------------------------------------------------------------
# the kernels' tile schedules, emulated
# ---------------------------------------------------------------------------


def _pad_to(t, n, dim, value=0.0):
    pad = [0, 0] * (t.dim() - dim - 1) + [0, n - t.shape[dim]]
    return torch.nn.functional.pad(t, pad, value=value)


def _tiled_forward(logits, stored, vh, keep=None, rate=0.0):
    """The forward kernel's per-row schedule on fp32 logits [B,H,N,N], the
    logits as stored and v [B,H,N,D] -> (out [B,H,N,D], stats [B,H,N,2])."""
    B, H, N, _ = logits.shape
    n_tiles = -(-N // TILE)
    width = n_tiles * TILE
    s_all = _pad_to(logits, width, 3, NEG_INF)            # keys past N at -inf
    st_all = _pad_to(stored.float(), width, 3, NEG_INF)
    v_all = _pad_to(vh, width, 2)                         # zero-filled rows
    k_all = None if keep is None else _pad_to(keep, width, 3, False)
    m_run = torch.full((B, H, N, 1), NEG_INF)
    l_run = torch.zeros((B, H, N, 1))
    ls_run = torch.zeros((B, H, N, 1))
    o = torch.zeros((B, H, N, vh.shape[-1]))
    for t in range(n_tiles):
        cols = slice(t * TILE, (t + 1) * TILE)
        s = s_all[..., cols]
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        alpha = torch.where(m_run == NEG_INF, torch.zeros(()), torch.exp(m_run - m_new))
        m_use = torch.where(torch.isfinite(m_new), m_new, torch.zeros(()))  # guard
        m_run = m_new
        p = torch.exp(s - m_use)
        l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)   # summed before dropout
        ls_run = ls_run * alpha + torch.exp(st_all[..., cols] - m_use).sum(dim=-1, keepdim=True)
        if k_all is not None:
            p = torch.where(k_all[..., cols], p, torch.zeros(()))
        o = o * alpha + torch.matmul(p, v_all[..., cols, :])
    inv = 1.0 / l_run.clamp_min(1e-30)
    scale = inv * drop.keep_scale(rate) if keep is not None else inv
    m_fin = torch.where(torch.isfinite(m_run), m_run, torch.zeros(()))
    return o * scale, torch.cat([m_fin, 1.0 / ls_run.clamp_min(1e-30)], dim=-1)


def _tiled_backward(qh, kh, vh, stored, oh, stats, gh, glog, keep, rate):
    """The backward kernel's schedule for every (b, h) at once: key tiles of
    64, query tiles of 64 inside each, entries past N zero-filled as the
    tile loads leave them.  dq keeps one running sum per row across the key
    tiles (the kernel's shared-memory buffer); dk and dv sum in a key tile's
    registers and are written when the tile ends (each row once, asserted
    here).  Returns (dq, dk, dv, dbias) head-major and the number of times
    each dbias entry was written."""
    B, H, N, D = qh.shape
    n_tiles = -(-N // TILE)
    W = n_tiles * TILE
    scale = D ** -0.5
    q, k, v = (_pad_to(t, W, 2) for t in (qh, kh, vh))
    g = None if gh is None else _pad_to(gh, W, 2)
    lg = _pad_to(_pad_to(stored.float(), W, 3, NEG_INF), W, 2)  # keys past N at -inf
    gl = torch.zeros_like(lg) if glog is None else _pad_to(_pad_to(glog.float(), W, 3), W, 2)
    kp = None if keep is None else _pad_to(_pad_to(keep, W, 3, False), W, 2, False)
    m = _pad_to(stats[..., 0], W, 2)
    inv = _pad_to(stats[..., 1], W, 2)                    # 0: rows past N add nothing
    r = torch.zeros((B, H, W)) if g is None else (g * _pad_to(oh, W, 2)).sum(dim=-1)
    c = drop.keep_scale(rate)
    dq_run = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dbias = torch.zeros((B, H, N, N))
    writes = torch.zeros((B, H, N, N), dtype=torch.int64)
    kv_writes = torch.zeros(W, dtype=torch.int64)
    for kt in range(n_tiles):
        cols = slice(kt * TILE, (kt + 1) * TILE)
        dk_acc = torch.zeros((B, H, TILE, D))
        dv_acc = torch.zeros((B, H, TILE, D))
        for qt in range(n_tiles):
            rows = slice(qt * TILE, (qt + 1) * TILE)
            p = torch.exp(lg[..., rows, cols] - m[..., rows, None]) * inv[..., rows, None]
            dp = (torch.zeros_like(p) if g is None
                  else torch.matmul(g[..., rows, :], v[..., cols, :].transpose(-1, -2)))
            pd = p
            if kp is not None:
                kept = kp[..., rows, cols]
                dp = torch.where(kept, dp * c, torch.zeros(()))
                pd = torch.where(kept, p * c, torch.zeros(()))
            dl = p * (dp - r[..., rows, None]) + gl[..., rows, cols]
            acc = dq_run[..., rows, :]                 # the running sum, then this tile
            for sub in range(0, TILE, STEP):
                ks = slice(sub, sub + STEP)
                acc = acc + torch.matmul(dl[..., ks], k[..., cols, :][..., ks, :])
            dq_run[..., rows, :] = acc
            for w in range(WARPS):                    # warp w's 16 keys of the tile
                ks = slice(w * 16, (w + 1) * 16)
                dk_acc[..., ks, :] += torch.matmul(dl[..., ks].transpose(-1, -2), q[..., rows, :])
                if g is not None:
                    dv_acc[..., ks, :] += torch.matmul(pd[..., ks].transpose(-1, -2),
                                                       g[..., rows, :])
            i1, j1 = min(N, (qt + 1) * TILE), min(N, (kt + 1) * TILE)
            if qt * TILE < N and kt * TILE < N:       # the tile's store: entries inside N x N
                dbias[..., qt * TILE:i1, kt * TILE:j1] = dl[..., :i1 - qt * TILE,
                                                            :j1 - kt * TILE]
                writes[..., qt * TILE:i1, kt * TILE:j1] += 1
        dk[..., cols, :] = dk_acc                     # the key tile ends: written once
        dv[..., cols, :] = dv_acc
        kv_writes[cols] += 1
    assert torch.equal(kv_writes, torch.ones_like(kv_writes))
    return dq_run[..., :N, :] * scale, dk[..., :N, :] * scale, dv[..., :N, :], dbias, writes


TILE_NS = [1, 63, 64, 65, 130]


def _heads_case(N, rate, pair_dtype, seed):
    B, H, D = 2, 2, 8
    q, k, v, g, bias, g_logits = (_tt(a) for a in _case(B, H, N, D, seed=seed,
                                                         first_tile=N > TILE))
    sd = torch.tensor([99], dtype=torch.int32) if rate else None
    out, stored, stats = ha.pair_bias_attention_plain(q, k, v, bias, H, pair_dtype, sd,
                                                            rate)
    keep = ha.keep_mask_for(sd, rate, B, H, N, N, None)
    return H, (q, k, v, g, bias, g_logits), (out, stored, stats), sd, keep


@pytest.mark.parametrize("pair_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("N", TILE_NS)
def test_tiled_forward_equals_whole_row_forward(N, rate, pair_dtype):
    H, (q, k, v, _, bias, _), (want_out, stored, want_stats), _, keep = _heads_case(
        N, rate, pair_dtype, seed=7)
    qh, kh, vh = (ha.split_heads(t, H) for t in (q, k, v))
    logits = torch.matmul(qh * qh.shape[-1] ** -0.5, kh.transpose(-1, -2)) + bias
    out, stats = _tiled_forward(logits, stored, vh, keep, rate)
    torch.testing.assert_close(ha.merge_heads(out), want_out, atol=ATT_ATOL, rtol=0)
    torch.testing.assert_close(stats, want_stats, atol=0, rtol=1e-5)
    assert torch.isfinite(want_out).all()
    if N > 2:   # the fully masked query row gives 0
        assert torch.equal(want_out[0, 2], torch.zeros_like(want_out[0, 2]))


@pytest.mark.parametrize("with_gl", [True, False], ids=["g_logits", "no_g_logits"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("N", TILE_NS)
def test_tiled_backward_equals_whole_row_backward(N, rate, with_gl):
    H, (q, k, v, g, _, g_logits), (out, stored, stats), sd, keep = _heads_case(
        N, rate, torch.float32, seed=8)
    gl = g_logits if with_gl else None
    want = ha.pair_bias_attention_stats_bwd_plain(q, k, v, stored, out, stats, g, gl, H, sd,
                                                  rate)
    heads = [ha.split_heads(t, H) for t in (q, k, v, out, g)]
    dq, dk, dv, dbias, writes = _tiled_backward(*heads[:3], stored, heads[3], stats, heads[4],
                                                gl, keep, rate)
    assert torch.equal(writes, torch.ones_like(writes))   # every dbias entry written once
    for n, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), want[:3]):
        torch.testing.assert_close(ha.merge_heads(a), b, atol=TILE_ATOL, rtol=0, msg=n)
    torch.testing.assert_close(dbias, want[3], atol=TILE_ATOL, rtol=0)
    oracle = ha.pair_bias_attention_bwd_plain(q, k, v, stored, g, gl, H, sd, rate)
    for a, b in zip(want, oracle):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("N", [63, 130])
def test_tiled_backward_without_g_out(N):
    """An absent g_out: dv is 0 and dL is g_logits alone."""
    H, (q, k, v, _, _, g_logits), (out, stored, stats), sd, keep = _heads_case(
        N, 0.2, torch.float32, seed=9)
    want = ha.pair_bias_attention_stats_bwd_plain(q, k, v, stored, out, stats, None, g_logits,
                                                  H, sd, 0.2)
    qh, kh, vh, oh = (ha.split_heads(t, H) for t in (q, k, v, out))
    dq, dk, dv, dbias, writes = _tiled_backward(qh, kh, vh, stored, oh, stats, None, g_logits,
                                                keep, 0.2)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(dv, torch.zeros_like(dv)) and torch.equal(dbias, g_logits)
    for a, b in zip((dq, dk), want[:2]):
        torch.testing.assert_close(ha.merge_heads(a), b, atol=TILE_ATOL, rtol=0)
    torch.testing.assert_close(want[3], g_logits, atol=0, rtol=0)
