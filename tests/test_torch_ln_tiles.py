"""The LayerNorm kernels' schedule on the CPU: an emulation of what
csrc/layer_norm.cu does, held to the plain versions and the JAX package.

* ``_lane_sum`` repeats a warp's row sum: lane l adds its 8-element chunks
  l, l+32, ... in order, then five butterfly steps give every lane the
  total.  ``_stats`` is row_stats on top of it (fast variance, eps inside
  the rsqrt).
* ``_emulated_forward`` walks the rows as the persistent forward does (warp
  w of block b takes rows b*8 + w, then every grid*8 further).
* ``_emulated_backward`` repeats the one-launch backward: the same walk,
  each warp summing gy*xhat and gy over its rows in order; the block's 8
  warp rows combined in the fixed tree (w += w+4, w += w+2, w += w+1); the
  8 blocks of a cluster added in rank order (rank q does it for its slice
  of the columns); the cluster rows added in cluster order (by the last
  block of each rank, for its slice).  The grids are those of
  hopper_ln.forward_grid / backward_grid for a given number of resident
  blocks.
Both are held to layer_norm_plain / layer_norm_bwd_plain at atol 1e-5
(scaled by the largest magnitude, as the summed gradients grow with T):
only the order of the sums differs.  (rsqrtf's approximation is not
emulated: on the card the kernels are held to the plain versions.)  The
backward is also held to mmdti_tpu.ops.pallas_ln run in interpret mode and
its jax.vjp at the 1e-4 of tests/test_torch_ln.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmdti_tpu.ops.pallas_ln as pln
from mmdti_tpu_torch.ops import hopper_ln as hl

TILE_ATOL = 1e-5
PALLAS_TOL = dict(atol=1e-4, rtol=1e-4)
H100_RESIDENT = 264   # blocks the backward could hold at once on 132 SMs, two a SM


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pln.pl, "pallas_call",
                        functools.partial(pln.pl.pallas_call, interpret=True))


def _case(T, E, seed=0):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (t(rng.randn(T, E) * 2 + 0.5), t(rng.rand(E) + 0.5), t(rng.randn(E) * 0.1),
            t(rng.randn(T, E)))


def _chunks(E):
    """kC of csrc/layer_norm.cu: 8-element chunks per lane."""
    return 1 if E <= 256 else 2 if E <= 512 else 4


def _lane_sum(a):
    """Row sums of a [T, E] as a warp takes them (a lane's chunks in order,
    then the butterfly), in fp32."""
    T, E = a.shape
    kc = _chunks(E)
    padded = torch.zeros(T, kc * 256)
    padded[:, :E] = a
    lanes = padded.view(T, kc, 32, 8).permute(0, 2, 1, 3).reshape(T, 32, kc * 8)
    s = torch.zeros(T, 32)
    for i in range(kc * 8):
        s = s + lanes[:, :, i]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ o]
    assert torch.equal(s, s[:, :1].expand(-1, 32))   # every lane holds the same bits
    return s[:, :1]


def _stats(x, eps):
    E = x.shape[1]
    mu = _lane_sum(x) / E
    var = (_lane_sum(x * x) / E - mu * mu).clamp_min(0.0)
    return mu, torch.rsqrt(var + eps)


def _walk(T, grid):
    """[grid * WARPS, k] row of each warp's k-th step (-1 past T), warp
    b*WARPS + w: the persistent kernels' schedule."""
    warps = grid * hl.WARPS
    steps = -(-T // warps)
    rows = torch.arange(warps)[:, None] + warps * torch.arange(steps)[None, :]
    return torch.where(rows < T, rows, -1)


def _emulated_forward(x, w, b, eps, grid):
    y = torch.full_like(x, float("nan"))
    for rows in _walk(x.shape[0], grid).t():      # one step of every warp at a time
        r = rows[rows >= 0]
        mu, rstd = _stats(x[r], eps)
        y[r] = (x[r] - mu) * (rstd * w) + b
    return y


def _emulated_backward(x, w, gy, eps, grid):
    T, E = x.shape
    assert grid % hl.CLUSTER == 0
    dx = torch.full_like(x, float("nan"))
    acc = torch.zeros(grid * hl.WARPS, 2 * E)     # each warp's dscale | dbias registers
    for rows in _walk(T, grid).t():
        live = rows >= 0
        r = rows[live]
        mu, rstd = _stats(x[r], eps)
        xh = (x[r] - mu) * rstd
        wd = gy[r] * w
        c1 = _lane_sum(wd * xh) / E
        c2 = _lane_sum(wd) / E
        dx[r] = (wd - xh * c1 - c2) * rstd
        acc[live] = acc[live] + torch.cat([gy[r] * xh, gy[r]], dim=1)
    part = acc.view(grid, hl.WARPS, 2 * E).clone()
    half = hl.WARPS // 2
    while half:                                    # the block's fixed tree
        part[:, :half] = part[:, :half] + part[:, half:2 * half]
        half //= 2
    blocks = part[:, 0].view(grid // hl.CLUSTER, hl.CLUSTER, 2 * E)
    rows = blocks[:, 0]
    for q in range(1, hl.CLUSTER):                 # a cluster's blocks in rank order
        rows = rows + blocks[:, q]
    total = rows[0]
    for c in range(1, rows.shape[0]):              # the last blocks: clusters in order
        total = total + rows[c]
    return dx, total[:E], total[E:]


def _close(got, want):
    torch.testing.assert_close(got, want, atol=TILE_ATOL * max(1.0, float(want.abs().max())),
                               rtol=0)


# (T, E, eps, resident blocks): T of one row, of one block, of 3 blocks'
# first rows, 2056 with a grid that divides nothing (136 blocks, 1 or 2 rows
# a warp) or few blocks (many rows a warp), and a T of four waves and more
CASES = [(1, 128, 1e-5, H100_RESIDENT), (8, 512, 1e-12, H100_RESIDENT),
         (24, 1024, 1e-5, H100_RESIDENT), (2056, 512, 1e-5, H100_RESIDENT),
         (2056, 128, 1e-12, 40), (2056, 1024, 1e-5, 24), (9000, 512, 1e-12, H100_RESIDENT)]


@pytest.mark.parametrize("T,E,eps,resident", CASES)
def test_grids_cover_every_row_once(T, E, eps, resident):
    fgrid, bgrid = hl.forward_grid(T, resident), hl.backward_grid(T, resident)
    assert 1 <= fgrid <= max(1, resident)
    assert bgrid % hl.CLUSTER == 0 and hl.CLUSTER <= bgrid <= max(hl.CLUSTER, resident)
    # the backward takes MIN_ROWS_PER_WARP rows a warp where T allows
    want = -(-T // (hl.WARPS * hl.MIN_ROWS_PER_WARP))
    assert bgrid == min(-(-want // hl.CLUSTER), resident // hl.CLUSTER) * hl.CLUSTER
    for grid in (fgrid, bgrid):
        rows = _walk(T, grid)
        assert torch.equal(torch.sort(rows[rows >= 0]).values, torch.arange(T))


@pytest.mark.parametrize("T,E,eps,resident", CASES)
def test_emulated_forward_matches_plain(T, E, eps, resident):
    x, w, b, _ = _case(T, E, seed=T + E)
    got = _emulated_forward(x, w, b, eps, hl.forward_grid(T, resident))
    _close(got, hl.layer_norm_plain(x, w, b, eps))


@pytest.mark.parametrize("T,E,eps,resident", CASES)
def test_emulated_backward_matches_plain(T, E, eps, resident):
    x, w, _, gy = _case(T, E, seed=T + E + 1)
    grid = hl.backward_grid(T, resident)
    got = _emulated_backward(x, w, gy, eps, grid)
    for name, a, c in zip(("dx", "dscale", "dbias"), got, hl.layer_norm_bwd_plain(x, w, gy, eps)):
        assert not torch.isnan(a).any(), name
        _close(a, c)


def test_emulated_backward_is_the_kernel_order():
    """The emulated dscale differs from the plain sum in its last bits at
    T=2056 (another order), and equals a sum taken in its own order again."""
    x, w, _, gy = _case(2056, 512, seed=5)
    grid = hl.backward_grid(2056, H100_RESIDENT)
    assert grid == 136
    a = _emulated_backward(x, w, gy, 1e-5, grid)
    b = _emulated_backward(x, w, gy, 1e-5, grid)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[1], hl.layer_norm_bwd_plain(x, w, gy, 1e-5)[1])


@pytest.mark.parametrize("T,E,eps,resident", [(24, 128, 1e-12, H100_RESIDENT),
                                              (2056, 512, 1e-5, 40)])
def test_emulated_schedule_matches_pallas_vjp(interpret_mode, T, E, eps, resident):
    x, w, b, gy = _case(T, E, seed=7)
    want_y, vjp = jax.vjp(lambda x_, w_, b_: pln.layer_norm_fused(x_, w_, b_, epsilon=eps),
                          *(jnp.asarray(t.numpy()) for t in (x, w, b)))
    want = vjp(jnp.asarray(gy.numpy()))
    y = _emulated_forward(x, w, b, eps, hl.forward_grid(T, resident))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **PALLAS_TOL)
    got = _emulated_backward(x, w, gy, eps, hl.backward_grid(T, resident))
    for name, a, c in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), err_msg=name, **PALLAS_TOL)
