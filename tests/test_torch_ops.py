"""mmdti_tpu_torch kernel modules against the JAX package.

The same numpy inputs (made from a seed) go through the JAX XLA oracle, the
JAX Pallas kernel in interpret mode, and the port's plain version of each
Hopper kernel.  Tolerance: atol 1e-5 in fp32, as tests/test_pallas.py holds
the Pallas kernels to the XLA oracle.  The kernels themselves run only on a
CUDA device: tests/test_torch_gpu.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmdti_tpu.ops.pallas_attention as pa
import mmdti_tpu.ops.pallas_gbf as pg
from mmdti_tpu.models.gaussian import gaussian_pdf as jax_gaussian_pdf
from mmdti_tpu.models.layers import get_activation_fn as jax_act
from mmdti_tpu.ops.attention import (
    cross_attention_xla,
    merge_padding_into_bias as jax_merge,
    pair_bias_attention_xla,
)
from mmdti_tpu_torch.ops import attention as tatt
from mmdti_tpu_torch.ops import hopper_attention as ha
from mmdti_tpu_torch.ops import hopper_gbf as hg

ATOL = 1e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the Pallas kernels in the interpreter, as tests/test_pallas.py does."""
    for mod in (pa, pg):
        monkeypatch.setattr(
            mod.pl, "pallas_call", functools.partial(mod.pl.pallas_call, interpret=True)
        )


def _tt(a):
    return torch.from_numpy(np.array(a))


def _heads(t, H):
    B, N, E = t.shape
    return t.reshape(B, N, H, E // H).transpose(0, 2, 1, 3)


def _tokens(t):
    B, H, N, D = t.shape
    return t.transpose(0, 2, 1, 3).reshape(B, N, H * D)


def _pair_inputs(B=2, H=4, N=16, D=8, pad_tail=3, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, N, H * D).astype(np.float32) for _ in range(3))
    bias = rng.randn(B, H, N, N).astype(np.float32)
    pad = np.zeros((B, N), bool)
    pad[1, N - pad_tail:] = True
    merged = np.array(jax_merge(jnp.asarray(bias), jnp.asarray(pad)))
    return q, k, v, bias, pad, merged


def _masked_inputs(B=2, H=4, Nq=16, Nk=24, D=8, fill=-10000.0, seed=1):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Nq, H * D).astype(np.float32)
    k, v = (rng.randn(B, Nk, H * D).astype(np.float32) for _ in range(2))
    keep = np.ones((B, Nk), np.float32)
    keep[0, Nk - 5:] = 0.0
    return q, k, v, (1.0 - keep) * np.float32(fill)


class TestPairBiasAttention:
    def test_plain_matches_xla_oracle(self):
        H = 4
        q, k, v, _, _, bias = _pair_inputs(H=H)
        o_x, l_x = pair_bias_attention_xla(
            *(_heads(jnp.asarray(t), H) for t in (q, k, v)), jnp.asarray(bias)
        )
        o_t, l_t = ha.pair_bias_attention_plain(_tt(q), _tt(k), _tt(v), _tt(bias), H)
        np.testing.assert_allclose(o_t.numpy(), _tokens(np.asarray(o_x)), atol=ATOL)
        l_x = np.asarray(l_x)
        fin = np.isfinite(l_x)
        np.testing.assert_allclose(l_t.numpy()[fin], l_x[fin], atol=ATOL)
        assert (np.isneginf(l_t.numpy()) == np.isneginf(l_x)).all()

    def test_plain_matches_pallas_interpret(self, interpret_mode):
        H = 4
        q, k, v, _, _, bias = _pair_inputs(H=H, N=24, seed=3)
        o_p, l_p = pa.pair_bias_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), num_heads=H
        )
        o_t, l_t = ha.pair_bias_attention_plain(_tt(q), _tt(k), _tt(v), _tt(bias), H)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_p), atol=ATOL)
        fin = np.isfinite(np.asarray(l_p))
        np.testing.assert_allclose(l_t.numpy()[fin], np.asarray(l_p)[fin], atol=ATOL)

    def test_oracle_path_matches_xla_oracle(self):
        H = 4
        q, k, v, _, _, bias = _pair_inputs(H=H, seed=5)
        o_x, l_x = pair_bias_attention_xla(
            *(_heads(jnp.asarray(t), H) for t in (q, k, v)), jnp.asarray(bias)
        )
        o_t, l_t = tatt.pair_bias_attention(
            _tt(q), _tt(k), _tt(v), _tt(bias), num_heads=H,
            pair_dtype=torch.float32, use_kernels=False,
        )
        np.testing.assert_allclose(o_t.numpy(), _tokens(np.asarray(o_x)), atol=ATOL)
        fin = np.isfinite(np.asarray(l_x))
        np.testing.assert_allclose(l_t.numpy()[fin], np.asarray(l_x)[fin], atol=ATOL)

    def test_merge_padding_matches_jax(self):
        _, _, _, bias, pad, merged = _pair_inputs()
        got = tatt.merge_padding_into_bias(_tt(bias), _tt(pad)).numpy()
        np.testing.assert_array_equal(got, merged)

    def test_fully_masked_row_is_zero_not_nan(self):
        """The TPU kernel's guard: a row whose keys are all -inf gives 0."""
        q, k, v, _, _, bias = _pair_inputs(H=2, N=8, D=4)
        bias[0, :, 2, :] = -np.inf
        out, _ = ha.pair_bias_attention_plain(_tt(q), _tt(k), _tt(v), _tt(bias), 2)
        assert np.isfinite(out.numpy()).all()
        np.testing.assert_array_equal(out.numpy()[0, 2], 0.0)


class TestMaskedAttention:
    @pytest.mark.parametrize("fill", [-10000.0, float(np.finfo(np.float32).min)])
    def test_plain_matches_xla_oracle_nq_ne_nk(self, fill):
        H = 4
        q, k, v, mask = _masked_inputs(H=H, fill=fill)
        want = cross_attention_xla(
            *(_heads(jnp.asarray(t), H) for t in (q, k, v)),
            jnp.asarray(mask)[:, None, None, :],
        )
        got, _ = ha.masked_attention_plain(_tt(q), _tt(k), _tt(v), _tt(mask), H)
        np.testing.assert_allclose(got.numpy(), _tokens(np.asarray(want)), atol=ATOL)

    def test_plain_matches_pallas_interpret(self, interpret_mode):
        H = 4
        q, k, v, mask = _masked_inputs(H=H, Nq=16, Nk=32, seed=4)
        want = pa.masked_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask)[:, None, :], num_heads=H,
        )
        got, _ = ha.masked_attention_plain(_tt(q), _tt(k), _tt(v), _tt(mask), H)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    def test_oracle_path_matches_xla_oracle(self):
        H = 2
        q, k, v, mask = _masked_inputs(H=H, Nq=8, Nk=12, D=16, seed=6)
        want = cross_attention_xla(
            *(_heads(jnp.asarray(t), H) for t in (q, k, v)),
            jnp.asarray(mask)[:, None, None, :],
        )
        got = tatt.masked_attention(_tt(q), _tt(k), _tt(v), _tt(mask), num_heads=H,
                                    use_kernels=False)
        np.testing.assert_allclose(got.numpy(), _tokens(np.asarray(want)), atol=ATOL)


def _gbf_params(K=16, Kh=16, H=8, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        means=rng.uniform(0, 3, K).astype(np.float32),
        stds=rng.uniform(-3, 3, K).astype(np.float32),
        w1=(0.1 * rng.randn(K, Kh)).astype(np.float32),     # flax [in, out]
        b1=(0.1 * rng.randn(Kh)).astype(np.float32),
        w2=(0.1 * rng.randn(Kh, H)).astype(np.float32),
        b2=(0.1 * rng.randn(H)).astype(np.float32),
    )


def _gbf_port(u, p, pad=None, act="gelu_tanh"):
    return hg.gbf_pair_bias_plain(
        _tt(u), _tt(p["means"]), _tt(p["stds"]), _tt(p["w1"].T), _tt(p["b1"]),
        _tt(p["w2"].T), _tt(p["b2"]), None if pad is None else _tt(pad), activation=act,
    ).numpy()


class TestFusedGbf:
    @pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
    def test_plain_matches_unfused_oracle(self, act):
        """Port's fused plain version vs the JAX GaussianLayer expansion +
        NonLinearHead math (fp32), in [B,H,N,N]."""
        p = _gbf_params()
        u = (np.random.RandomState(1).rand(2, 16, 16) * 6).astype(np.float32)
        std = jnp.abs(jnp.asarray(p["stds"])) + 1e-5
        feat = jax_gaussian_pdf(jnp.asarray(u)[..., None], jnp.asarray(p["means"]), std)
        h = jax_act(act)(feat @ jnp.asarray(p["w1"]) + jnp.asarray(p["b1"]))
        want = np.asarray(h @ jnp.asarray(p["w2"]) + jnp.asarray(p["b2"]))
        np.testing.assert_allclose(_gbf_port(u, p, act=act), want.transpose(0, 3, 1, 2),
                                   atol=ATOL)

    def test_plain_matches_pallas_interpret_with_pad_merge(self, interpret_mode):
        p = _gbf_params(seed=2)
        u = (np.random.RandomState(3).rand(2, 16, 16) * 6).astype(np.float32)
        pad = np.zeros((2, 16), bool)
        pad[0, 12:] = True
        pallas = pg.gbf_pair_bias_fused(
            jnp.asarray(u), *(jnp.asarray(p[n]) for n in ("means", "stds", "w1", "b1",
                                                         "w2", "b2"))
        )                                                       # [B,N,H,N]
        want = np.asarray(jax_merge(jnp.transpose(pallas, (0, 2, 1, 3)), jnp.asarray(pad)))
        got = _gbf_port(u, p, pad)
        assert (np.isneginf(got) == np.isneginf(want)).all()
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=ATOL)

    def test_bf16_compute_rounds_gemm_operands(self):
        """compute_dtype=bf16 rounds G/h/weights like the TPU kernel's
        astype(cdt): the result differs from fp32 by bf16 resolution only."""
        p = _gbf_params(seed=4)
        u = (np.random.RandomState(5).rand(1, 8, 8) * 6).astype(np.float32)
        args = (_tt(u), _tt(p["means"]), _tt(p["stds"]), _tt(p["w1"].T), _tt(p["b1"]),
                _tt(p["w2"].T), _tt(p["b2"]))
        f32 = hg.gbf_pair_bias_plain(*args).numpy()
        bf = hg.gbf_pair_bias_plain(*args, compute_dtype=torch.bfloat16).numpy()
        assert not np.array_equal(f32, bf)
        np.testing.assert_allclose(bf, f32, atol=2e-2)


class TestDispatch:
    def test_cpu_tensors_take_plain_versions_and_count_no_launch(self):
        counters = (ha.pair_bias_attention_cuda, ha.masked_attention_cuda,
                    hg.gbf_pair_bias_cuda)
        before = [c.launches for c in counters]
        q, k, v, _, pad, bias = _pair_inputs(H=2, N=8, D=4)
        o, l = ha.pair_bias_attention_fused(_tt(q), _tt(k), _tt(v), _tt(bias), num_heads=2)
        o2, l2 = ha.pair_bias_attention_plain(_tt(q), _tt(k), _tt(v), _tt(bias), 2)
        assert torch.equal(o, o2) and torch.equal(l, l2)
        q, k, v, mask = _masked_inputs(H=2, Nq=8, Nk=12, D=4)
        assert torch.equal(
            ha.masked_attention_fused(_tt(q), _tt(k), _tt(v), _tt(mask), num_heads=2),
            ha.masked_attention_plain(_tt(q), _tt(k), _tt(v), _tt(mask), 2)[0],
        )
        p = _gbf_params()
        u = np.random.RandomState(0).rand(1, 8, 8).astype(np.float32)
        args = (_tt(u), _tt(p["means"]), _tt(p["stds"]), _tt(p["w1"].T), _tt(p["b1"]),
                _tt(p["w2"].T), _tt(p["b2"]))
        assert torch.equal(hg.gbf_pair_bias_fused(*args), hg.gbf_pair_bias_plain(*args))
        assert [c.launches for c in counters] == before

    def test_launchers_refuse_cpu_tensors(self):
        q, k, v, _, _, bias = _pair_inputs(H=2, N=8, D=4)
        with pytest.raises(ValueError, match="CUDA"):
            ha.pair_bias_attention_cuda(_tt(q), _tt(k), _tt(v), _tt(bias), 2)
        q, k, v, mask = _masked_inputs(H=2, Nq=8, Nk=12, D=4)
        with pytest.raises(ValueError, match="CUDA"):
            ha.masked_attention_cuda(_tt(q), _tt(k), _tt(v), _tt(mask), 2)

    def test_dropout_replays_its_mask_in_backward(self):
        """On CPU tensors the differentiable op runs the plain forward and
        the plain backward; with dropout on, its gradients equal autograd
        through the plain forward on the same seed, so the backward drops
        the probabilities the forward dropped."""
        H, rate = 2, 0.3
        q, k, v, _, _, bias = _pair_inputs(H=H, N=8, D=4)
        seed = torch.tensor([12345], dtype=torch.int32)
        g = torch.from_numpy(np.random.RandomState(9).randn(*q.shape).astype(np.float32))

        def grads(fn):
            ins = [_tt(t).requires_grad_() for t in (q, k, v)]
            out, _ = fn(*ins)
            (out * g).sum().backward()
            return [t.grad for t in ins]

        got = grads(lambda *a: ha.pair_bias_attention_fused(
            *a, _tt(bias), num_heads=H, dropout_rate=rate, seed=seed, deterministic=False))
        want = grads(lambda *a: ha.pair_bias_attention_plain(
            *a, _tt(bias), H, seed=seed, dropout_rate=rate))
        no_drop = grads(lambda *a: ha.pair_bias_attention_plain(*a, _tt(bias), H))
        for a, b, c in zip(got, want, no_drop):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
            assert not torch.allclose(a, c, atol=1e-3)
