"""The bf16 ("mma") route of the fused Gaussian + gbf_proj kernels on the
CPU: the route function, and an emulation of the tensor-core kernels' tile
schedule against the plain versions and the JAX package.

* ``_tiled_forward`` repeats, in PyTorch, what csrc/gbf_proj.cu's
  gbf_mma_fwd_kernel does: flat pairs p = (b*N + i)*N + j in 16-pair warp
  tiles that cross row and batch ends, the hidden layer made and consumed
  in 16-column chunks (the output summed chunk by chunk), -inf at padded
  keys, and each tile stored in 16-element runs per head when it lies in
  one batch row and N*N keeps the runs 16-byte aligned, else one element
  at a time.
* ``_tiled_backward`` repeats gbf_mma_bwd_kernel's schedule: 64-pair block
  tiles dealt to ``grid`` persistent blocks in turn; per tile the cotangent
  zeroed at padded keys and past the end, its sums per (head, 16-pair run)
  for db2; per K half and 32-column chunk h_pre, dh and dpre; dG per half,
  du as the sum of the two halves; dW1 and dW2 summed over the tile's pairs
  into the block's partials; db1, dmeans and dstd per warp (16 pairs),
  added in warp order; the blocks' partials added in block order.
  In fp32 compute both must equal gbf_pair_bias_plain /
  gbf_pair_bias_bwd_plain at atol 1e-5: only the order of the sums differs.
  (The kernels' ex2.approx and tanh.approx are not emulated: on the card
  they are held to the plain versions at the bf16 tolerances.)
* Both are held to mmdti_tpu.ops.pallas_gbf run in interpret mode and its
  jax.vjp at the tolerances of tests/test_torch_backward.py (atol 3e-4,
  rtol 1e-4).
The kernels themselves run only on a CUDA card (tests/test_torch_gpu.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmdti_tpu.ops.pallas_gbf as pg
from mmdti_tpu.ops.attention import merge_padding_into_bias as jax_merge
from mmdti_tpu_torch.ops import hopper_gbf as hg

TILE_ATOL = 1e-5
GBF_TOL = dict(atol=3e-4, rtol=1e-4)
FWD_PAIRS = 16    # pairs a forward warp takes at a time
FWD_CHUNK = 16    # hidden columns the forward makes and consumes at once
CHUNK = 32        # columns of a K or Kh half the backward takes at once
BLOCK_PAIRS = 64  # pairs per block tile of the backward
RUN = 16          # pairs per cotangent run a thread loads


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pg.pl, "pallas_call",
                        functools.partial(pg.pl.pallas_call, interpret=True))


def _case(B, N, K=128, H=64, seed=0):
    """u, means, stds (positive), w1 [Kh,K], b1, w2 [H,Kh], b2 as torch fp32
    (nn.Linear layout), pad [B,N] bool (batch row 1 pads its last keys) and
    the cotangent g [B,H,N,N]."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    params = (t(rng.rand(B, N, N) * 6), t(rng.uniform(0, 3, K)), t(rng.uniform(0.5, 3, K)),
              t(0.1 * rng.randn(K, K)), t(0.1 * rng.randn(K)), t(0.1 * rng.randn(H, K)),
              t(0.1 * rng.randn(H)))
    pad = np.zeros((B, N), bool)
    if B > 1:
        pad[1, N - max(1, N // 4):] = True
    return params, torch.from_numpy(pad), t(rng.randn(B, H, N, N))


def _gauss(u, means, std):
    return hg.gaussian_pdf(u[:, None], means, std)


def _tiled_forward(u, means, stds, w1, b1, w2, b2, pad, act):
    B, N, _ = u.shape
    H = w2.shape[0]
    NN, total = N * N, B * N * N
    std = stds.abs() + 1e-5
    uf = u.reshape(-1)
    out = torch.full((B, H, NN), float("nan"))
    pad_flat = pad.reshape(-1)
    for p0 in range(0, total, FWD_PAIRS):
        p = torch.arange(p0, p0 + FWD_PAIRS)
        live = p < total
        g = _gauss(torch.where(live, uf[p.clamp(max=total - 1)], 0.0), means, std)
        o = torch.zeros(FWD_PAIRS, H)
        for c in range(0, w1.shape[0], FWD_CHUNK):
            h = hg._act(act, g @ w1[c:c + FWD_CHUNK].t() + b1[c:c + FWD_CHUNK])
            o = o + h @ w2[:, c:c + FWD_CHUNK].t()
        o = o + b2
        b, rem = p // NN, p % NN
        masked = pad_flat[(b * N + rem % N).clamp(max=B * N - 1)] & live
        stg = torch.where(masked[:, None], float("-inf"), o).t()          # [H, 16]
        b0, rem0 = p0 // NN, p0 % NN
        if p0 + FWD_PAIRS <= total and rem0 + FWD_PAIRS <= NN and NN % 8 == 0:
            out[b0, :, rem0:rem0 + FWD_PAIRS] = stg                        # 16-byte runs
        else:
            for r in range(FWD_PAIRS):                                    # one element a lane
                if p0 + r < total:
                    out[int(b[r]), :, int(rem[r])] = stg[:, r]
    return out.view(B, H, N, N)


def _tiled_backward(u, means, std, w1, b1, w2, g, pad, act, grid):
    B, N, _ = u.shape
    Kh, K = w1.shape
    H = w2.shape[0]
    NN, total = N * N, B * N * N
    half_k, half_h = K // 2, Kh // 2
    uf, gf = u.reshape(-1), g.reshape(B, H, NN)
    pad_flat = pad.reshape(-1)
    ntiles = -(-total // BLOCK_PAIRS)
    du = torch.zeros(total)
    blocks = []
    for blk in range(min(grid, ntiles)):
        part = dict(dw1=torch.zeros(Kh, K), dw2=torch.zeros(H, Kh), db2=torch.zeros(H, 4),
                    db1=torch.zeros(8, Kh), dmu=torch.zeros(8, K), dsd=torch.zeros(8, K))
        for tile in range(blk, ntiles, grid):
            p = torch.arange(tile * BLOCK_PAIRS, (tile + 1) * BLOCK_PAIRS)
            live = p < total
            pc = p.clamp(max=total - 1)
            b, rem = pc // NN, pc % NN
            keep = live & ~pad_flat[b * N + rem % N]
            go = torch.where(keep[:, None], gf[b, :, rem], 0.0)                  # [64, H]
            part["db2"] += go.t().reshape(H, 4, RUN).sum(-1)
            uu = torch.where(live, uf[pc], 0.0)
            gk = _gauss(uu, means, std)                                          # [64, K]
            z = (uu[:, None] - means) / std
            h = torch.empty(BLOCK_PAIRS, Kh)
            dpre = torch.empty(BLOCK_PAIRS, Kh)
            for hf in range(2):          # warps 4 hf .. 4 hf + 3, 16 pairs each
                for c in range(hf * half_h, (hf + 1) * half_h, CHUNK):
                    cols = slice(c, c + CHUNK)
                    dh = go @ w2[:, cols]
                    hp = gk @ w1[cols].t() + b1[cols]
                    h[:, cols] = hg._act(act, hp)
                    dpre[:, cols] = dh * hg._act_grad(act, hp)
                    part["db1"][4 * hf:4 * hf + 4, cols] += dpre[:, cols].view(4, 16, -1).sum(1)
            du_half = []
            for hf in range(2):
                ks = slice(hf * half_k, (hf + 1) * half_k)
                dgz = (dpre @ w1[:, ks]) * gk[:, ks]
                zs = z[:, ks] / std[ks]
                part["dmu"][4 * hf:4 * hf + 4, ks] += (dgz * zs).view(4, 16, -1).sum(1)
                part["dsd"][4 * hf:4 * hf + 4, ks] += (
                    dgz * (z[:, ks] ** 2 - 1.0) / std[ks]).view(4, 16, -1).sum(1)
                du_half.append((-dgz * zs).sum(1))
            du[p[live]] = (du_half[0] + du_half[1])[live]
            part["dw1"] += dpre.t() @ gk
            part["dw2"] += go.t() @ h
        db2 = part["db2"]
        blocks.append((part["dw1"], part["dw2"], part["db1"].sum(0),
                       (db2[:, 0] + db2[:, 1]) + (db2[:, 2] + db2[:, 3]),
                       part["dmu"].sum(0), part["dsd"].sum(0)))
    dw1, dw2, db1, db2, dmu, dsd = (functools.reduce(torch.add, parts)
                                    for parts in zip(*blocks))
    return du.view(u.shape), dmu, dsd, dw1, db1, dw2, db2


@pytest.mark.parametrize("compute,K,Kh,H,want", [
    (torch.bfloat16, 128, 128, 64, "mma"),
    (torch.bfloat16, 128, 128, 96, "mma"),
    (torch.float32, 128, 128, 64, "fma"),
    (torch.bfloat16, 64, 128, 64, "fma"),
    (torch.bfloat16, 128, 128, 8, "fma"),
    (torch.bfloat16, 128, 128, 16, "mma"),
    (torch.bfloat16, 128, 128, 32, "mma"),
    (torch.bfloat16, 128, 128, 48, "mma"),
])
def test_route_follows_compute_dtype_and_widths(compute, K, Kh, H, want):
    assert hg.gbf_route(compute, K, Kh, H) == want


def test_route_rejects_other_compute_dtypes():
    with pytest.raises(TypeError, match="compute_dtype"):
        hg.gbf_route(torch.float16, 128, 128, 64)


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
@pytest.mark.parametrize("N", [1, 8, 24, 65])
def test_tiled_forward_matches_plain(N, act):
    (u, means, stds, w1, b1, w2, b2), pad, _ = _case(2, N, seed=N)
    got = _tiled_forward(u, means, stds, w1, b1, w2, b2, pad, act)
    want = hg.gbf_pair_bias_plain(u, means, stds, w1, b1, w2, b2, pad, act)
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=TILE_ATOL, rtol=0)


@pytest.mark.parametrize("grid", [1, 3, 7])
@pytest.mark.parametrize("N", [1, 8, 24, 65])
def test_tiled_backward_matches_plain(N, grid):
    act = "gelu" if N % 2 else "gelu_tanh"
    H = 96 if N == 24 else 64
    (u, means, stds, w1, b1, w2, _), pad, g = _case(2, N, H=H, seed=10 + N)
    std = stds.abs() + 1e-5
    got = _tiled_backward(u, means, std, w1, b1, w2, g, pad, act, grid)
    want = hg.gbf_pair_bias_bwd_plain(u, means, std, w1, b1, w2, g, pad, act)
    for name, a, b in zip(("du", "dmeans", "dstd", "dw1", "db1", "dw2", "db2"), got, want):
        torch.testing.assert_close(a, b, atol=TILE_ATOL * max(1.0, float(b.abs().max())),
                                   rtol=0, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
def test_tiled_schedule_matches_pallas_forward_and_vjp(interpret_mode, act):
    (u, means, stds, w1, b1, w2, b2), pad, g = _case(2, 16, seed=3)

    def jax_fn(u, means, stds, w1, b1, w2, b2):
        out = pg.gbf_pair_bias_fused(u, means, stds, w1, b1, w2, b2, activation=act)
        return jax_merge(jnp.transpose(out, (0, 2, 1, 3)), jnp.asarray(pad.numpy()))

    flax = (u, means, stds, w1.t(), b1, w2.t(), b2)   # flax Dense kernels are [in, out]
    want_out, vjp = jax.vjp(jax_fn, *(jnp.asarray(t.contiguous().numpy()) for t in flax))
    want = [np.asarray(w) for w in vjp(jnp.asarray(g.numpy()))]

    out = _tiled_forward(u, means, stds, w1, b1, w2, b2, pad, act).numpy()
    want_out = np.asarray(want_out)
    assert np.array_equal(np.isneginf(out), np.isneginf(want_out))
    fin = np.isfinite(want_out)
    np.testing.assert_allclose(out[fin], want_out[fin], **GBF_TOL)

    du, dmeans, dstd, dw1, db1, dw2, db2 = _tiled_backward(
        u, means, stds.abs() + 1e-5, w1, b1, w2, g, pad, act, grid=2)
    got = (du, dmeans, dstd, dw1.t(), db1, dw2.t(), db2)   # stds > 0: d|stds| = dstd
    for name, a, b in zip(("u", "means", "stds", "w1", "b1", "w2", "b2"), got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"grad {name}", **GBF_TOL)
