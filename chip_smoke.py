#!/usr/bin/env python3
"""Smoke run of mmdti_tpu_torch on one CUDA card (H100): the serving slice,
the train step, and fit-and-predict through MolTrain/MolPredict.

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the Hopper kernels from mmdti_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card, fp32 (TF32
   off) and bf16, at the flagship shapes, with padded keys: the attention
   forwards without and with dropout (0.1, same seed; the keep fraction is
   printed beside 0.9), the three backwards (dropout 0 and 0.1, with and
   without the logits cotangent for pair-bias; bf16 pair-bias and masked
   attention run the tensor-core route, whose forward also returns the row
   stats and whose backward is held both to its own plain version and to
   the recompute oracle, repeated calls bit-equal, with profiler device
   times: masked beside SDPA's forward and forward + autograd backward,
   pair-bias beside the row kernels it replaced at the same bf16 inputs and
   SDPA with the bias as a float mask, a partial yardstick; gbf's device
   times too), and the LayerNorm forward
   and backward ([2048, 512] and [8960, 512], x and y in fp32 and bf16,
   eps 1e-5 and 1e-12; repeated backwards must give bit-equal dscale and
   dbias).  Each line has the max
   error beside its tolerance, the kernel's time, the plain version's, the
   PyTorch library call's where one computes the same function (SDPA for
   the masked forward), and the bound: the least time the card could take
   for the same bytes and operations (CUDA events, median of 25 launches);
4. a flagship-width MolServe on the card (weights drawn from a seeded
   torch.Generator) answers requests of 1, 8 and 20 SMILES; prints the
   per-request p50, the kernel launch counts of that run (gbf 1, pair-bias
   15, masked 8 per forward, no backward, the attention on the tensor-core
   route) and the largest logit difference
   between the kernel path and the same weights on the plain path;
5. train: the flagship model (bf16 compute, bf16 pair logits) on a batch of
   32 molecules featurized and collated on the host (N=L=64), regression
   (MSE + InfoNCE + ct_regress): (a) one step's loss and gradients, dropout
   off, on the kernel path against the plain path, at L=64 and at the top
   SMILES bucket L=512, every masked launch on the tensor-core route; (b)
   30 steps with
   dropout on, each loss finite and the last below the first; (c) step time
   p50, mols/s and launches per step (exactly gbf 1/1, pair-bias 15/15,
   masked 8/8 forward/backward, the attention all on the tensor-core
   route), a torch.profiler summary of 3 steps (device time, the pair-bias
   and masked kernels' shares) and the launches of one clip + Adam update;
   (d) one step at the top atom bucket N=280 with its peak memory, device
   time and the pair-bias kernels' share of it;
   (e) one step at N=64, L=512: masked launches per route, device time, the
   masked kernels' share of it and peak memory;
6. fit, with MMDTI_PALLAS_LN=1 for this phase only: the 400-molecule
   synthetic regression set (seed 0), scaffold-split (seed 0), then
   MolTrain.fit(train, val) at the flagship width and depth (bf16, B=32,
   3 epochs, dropout, InfoNCE, CT, sample weights, FDS) and
   MolPredict.predict(test); prints the featurization and per-epoch
   seconds, the LayerNorm launch counts (forward, backward and reduce,
   checked against the 49 LayerNorms of a forward), the artifacts, the
   reloaded predictions against the fit's own, the kernel path against the
   plain path on the same checkpoint, and the test RMSE (a record);
7. one JSON line with every kernel's summary, then {"ok": true, ...}.

Imports nothing of JAX.  Without CUDA, or without the package beside this
file, it prints no result and exits 2.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the SMILES of the repo's test fixtures (tests/conftest.py)
SMILES_20 = [
    "CCO", "CC(=O)O", "c1ccccc1", "Cc1ccccc1", "CC(C)O", "CCCC", "CCN",
    "c1ccncc1", "CC(=O)Oc1ccccc1C(=O)O", "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "C1CCCCC1", "O=C1CCCCC1", "CCOC(=O)C", "CCS", "NCCO", "OCC(O)CO",
    "Clc1ccccc1", "Brc1ccccc1", "FC(F)(F)c1ccccc1", "N#Cc1ccccc1",
]
REQUESTS = (1, 8, 20)
REPEATS = 10
TOL = {  # (atol, rtol) per precision; bf16 as tests/test_pallas.py:69-73
    "fp32": {"out": (1e-4, 0.0), "logits": (1e-4, 0.0)},
    "bf16": {"out": (2e-2, 0.0), "logits": (5e-2, 1e-2)},
}
# gradients: the forward's output bound, scaled by the largest magnitude of
# the plain gradient (each is a sum over a whole row or column of scores)
GRAD_TOL = {"fp32": 1e-4, "bf16": 2e-2}
LOGITS_TOL = 2e-2  # kernel vs plain path, flagship logits (bf16 compute)
# train step, kernel vs plain path, bf16: largest |dg| / max|g| over the
# parameters (phase_train).  The plain path rounds the probabilities to bf16
# before PV and the kernels do not, so the paths differ by bf16 resolution
# (~4e-3) per layer, compounded through the 23 attention layers of the
# backward; a wrong gradient differs by order 1
TRAIN_GRAD_TOL = 1e-1
TRAIN_LOSS_TOL = 2e-2
DROPOUT = 0.1
TRAIN_STEPS = 30
# H100 SXM datasheet peaks: HBM bytes/s; dense FLOP/s by
# operand type (fp32 runs outside the tensor cores, TF32 being off)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
BYTES = {"bf16": 2, "fp32": 4}

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "gbf_proj": ("mmdti_tpu_torch/csrc/gbf_proj.cu", "mmdti_tpu/ops/pallas_gbf.py:117"),
    "gbf_proj_bwd": ("mmdti_tpu_torch/csrc/gbf_proj.cu", "mmdti_tpu/ops/pallas_gbf.py:141"),
    "pair_bias_attention": ("mmdti_tpu_torch/csrc/pair_bias_attention.cu",
                            "mmdti_tpu/ops/pallas_attention.py:166"),
    "pair_bias_attention_bwd": ("mmdti_tpu_torch/csrc/pair_bias_attention.cu",
                                "mmdti_tpu/ops/pallas_attention.py:192"),
    "masked_attention": ("mmdti_tpu_torch/csrc/masked_attention.cu",
                         "mmdti_tpu/ops/pallas_attention.py:590"),
    "masked_attention_bwd": ("mmdti_tpu_torch/csrc/masked_attention.cu",
                             "mmdti_tpu/ops/pallas_attention.py:619"),
    "layer_norm": ("mmdti_tpu_torch/csrc/layer_norm.cu", "mmdti_tpu/ops/pallas_ln.py:110"),
    "layer_norm_bwd": ("mmdti_tpu_torch/csrc/layer_norm.cu", "mmdti_tpu/ops/pallas_ln.py:123"),
}
TRAIN_KERNELS = tuple(KERNELS)[:6]   # launched by phase 5; the LayerNorms by phase 6
# LayerNorm (atol, rtol): fp32 as tests/test_pallas_ln.py:45-52; a bf16
# output may round one bf16 step (2^-8 of its value) either side of the plain one
LN_FWD_TOL = {"fp32": (2e-5, 0.0), "bf16": (2e-2, 1e-2)}
FIT_MOLECULES, FIT_EPOCHS = 400, 3
SDPA_PAIR_IS = ("SDPA with the bias as a float attn_mask: a partial yardstick, it writes no "
                "logits and takes no logits cotangent")
# per-case numbers that the main case also carries into the kernels line;
# the case's "route" (the attention's dtype route) goes there as
# "dtype_route", since that line's "route" names the language (cuda)
SUMMARY_EXTRAS = ("device_ms", "fwd_bwd_device_ms", "rows_device_ms", "rows_fwd_bwd_device_ms",
                  "sdpa_device_ms", "sdpa_fwd_bwd_device_ms", "library_device_ms")


class Failed(RuntimeError):
    pass


def _counters():
    from mmdti_tpu_torch.ops import hopper_attention as ha
    from mmdti_tpu_torch.ops import hopper_gbf as hg
    from mmdti_tpu_torch.ops import hopper_ln as hl

    return {"gbf_proj": hg.gbf_pair_bias_cuda, "gbf_proj_bwd": hg.gbf_pair_bias_bwd_cuda,
            "pair_bias_attention": ha.pair_bias_attention_cuda,
            "pair_bias_attention_bwd": ha.pair_bias_attention_bwd_cuda,
            "masked_attention": ha.masked_attention_cuda,
            "masked_attention_bwd": ha.masked_attention_bwd_cuda,
            "layer_norm": hl.layer_norm_cuda, "layer_norm_bwd": hl.layer_norm_bwd_cuda,
            "layer_norm_bwd_reduce": hl.layer_norm_bwd_reduce_cuda}


def _reset_counts():
    for c in _counters().values():
        c.launches = 0
        for route in getattr(c, "routes", {}):
            c.routes[route] = 0


def _read_counts():
    return {k: c.launches for k, c in _counters().items()}


def _read_routes():
    """Launches per route of the attention launchers: "mma" (bf16, tensor
    cores) and "rows" (fp32)."""
    return {k: dict(c.routes) for k, c in _counters().items() if hasattr(c, "routes")}


def _time_ms(fn, iters=25, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, n=20):
    """Device time per call: the CUDA kernels' own time in a torch.profiler
    window of n calls, over n (the host's issue time left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n / 1e3


def _bound(nbytes, flops, prec):
    """(ms, what bounds it): the larger of bytes over HBM rate and FLOPs
    over the peak rate of the precision."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[prec] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _err(got, want, atol, rtol):
    """(max abs error over finite entries, ok) with matching -inf patterns."""
    import torch

    got, want = got.float(), want.float()
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        return float("inf"), False
    if not torch.isfinite(got[~torch.isneginf(got)]).all():
        return float("nan"), False
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    ok = bool((diff <= atol + rtol * want[fin].abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def _grad_errs(names, got, want, prec):
    errs = {}
    for n, g, w in zip(names, got, want):
        tol = GRAD_TOL[prec] * max(1.0, float(w.float().abs().max()))
        e, ok = _err(g, w, tol, 0.0)
        errs[n] = (e, tol, ok)
    return errs


def _pair_stats_errs(logits, stats, want_s):
    """The bf16 pair-bias forward's row stats: the guarded max against the
    plain version's (abs 1e-3), and 1/rowsum against the plain sum over the
    kernel's own stored logits (rel 1e-3)."""
    import torch

    e, ok = _err(stats[..., 0], want_s[..., 0], 1e-3, 0.0)
    inv = 1.0 / torch.exp(logits.float() - stats[..., :1]).sum(dim=-1).clamp_min(1e-30)
    rel = float(((stats[..., 1] - inv).abs() / inv).max())
    return {"stats_max": (e, 1e-3, ok), "stats_inv_rel": (rel, 1e-3, rel <= 1e-3)}


class _PairRows:
    """The pair-bias row kernels, the route bf16 took before the tensor-core
    kernels, launched through their C entry points at the same bf16 inputs
    for device times beside the "mma" route (not counted as launches)."""

    def __init__(self, q, k, v, bias, logits, g_out, g_logits, H, seed, rate):
        import torch

        from mmdti_tpu_torch.ops import _build
        from mmdti_tpu_torch.ops import hopper_attention as ha

        B, N, E = q.shape
        self.lib = _build.load("pair_bias_attention")
        self.inputs, self.bias, self.logits = (q, k, v), bias, logits
        self.cots = (g_out, g_logits)
        self.drop = ha._dropout_args(seed, rate, q.device)
        self.tail = (B, N, H, E // H, 1, 1, torch.cuda.current_stream(q.device).cuda_stream)
        self.out, self.new_logits = torch.empty_like(q), torch.empty_like(bias)
        self.grads = [torch.empty_like(t) for t in (q, k, v, bias)]
        self.ws = torch.empty((B, H, N, 3), dtype=torch.float32, device=q.device)

    def fwd(self):
        rc = self.lib.mmdti_pair_bias_attention_fwd(
            *(t.data_ptr() for t in (*self.inputs, self.bias, self.out, self.new_logits)),
            *self.drop, *self.tail)
        if rc:
            raise Failed(f"pair-bias row forward failed with cudaError_t {rc}")

    def bwd(self, logits=None):
        rc = self.lib.mmdti_pair_bias_attention_bwd(
            *(t.data_ptr() for t in self.inputs), (self.logits if logits is None
                                                   else logits).data_ptr(),
            *(None if t is None else t.data_ptr() for t in self.cots),
            *(t.data_ptr() for t in (*self.grads, self.ws)), *self.drop, *self.tail)
        if rc:
            raise Failed(f"pair-bias row backward failed with cudaError_t {rc}")

    def fwd_bwd(self):
        self.fwd()
        self.bwd(self.new_logits)


class _PairSdpa:
    """SDPA with the pair bias as a float attn_mask on the same inputs."""

    def __init__(self, q, k, v, bias, g_out, rate):
        B, N, E = q.shape
        H = bias.shape[1]
        self.leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
        self.heads = [t.view(B, N, H, E // H).transpose(1, 2) for t in self.leaves[:3]]
        self.g = g_out.view(B, N, H, E // H).transpose(1, 2)
        self.rate = rate

    def fwd(self):
        import torch.nn.functional as F

        return F.scaled_dot_product_attention(*self.heads, attn_mask=self.leaves[3],
                                              dropout_p=self.rate)

    def fwd_bwd(self):
        import torch

        return torch.autograd.grad(self.fwd(), self.leaves, self.g)


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(out, flush=True)
    return out


def phase_build():
    from mmdti_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"build: {len(paths)} libraries in {secs:.1f} s ({_build.BUILD_DIR})", flush=True)
    for name in paths:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            regs = [ln.strip() for ln in f if "registers" in ln]
        print(f"build: {name}: {len(regs)} kernel variants, e.g. {regs[:1]}", flush=True)
    return secs


def _padded_lengths(gen, B, N):
    import torch

    return torch.randint(max(2, N // 2), N + 1, (B,), generator=gen)


class _Recorder:
    """Prints one line per case and keeps, per kernel, the largest error and
    the numbers of its main case (B=32 at the N=L=64 train shape, bf16,
    dropout on where the kernel takes it)."""

    def __init__(self):
        self.summary, self.failures = {}, []

    def __call__(self, kernel, case, prec, errs, ms, plain_ms, library_ms, bound, main,
                 extra=None):
        line = {"kernel": kernel, "case": case, "precision": prec, "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound[0],
                "bound_by": bound[1], **(extra or {})}
        for what, (err, tol, ok) in errs.items():
            line[f"{what}_max_abs_err"] = err
            line[f"{what}_tol"] = tol
            if not ok:
                self.failures.append(f"{kernel} {case} {prec} {what}: err {err} tol {tol}")
        print("kernel: " + json.dumps(line), flush=True)
        s = self.summary.setdefault(kernel, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], *(e for e, _, _ in errs.values()))
        if main:
            s.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound[0],
                     bound_by=bound[1], **{k: v for k, v in line.items() if k in SUMMARY_EXTRAS})
            if "route" in line:
                s["dtype_route"] = line["route"]


def _pair_bias_cases(dev, gen, seed, record, B=32, H=64, D=8, Ns=(64, 280)):
    """Pair-bias attention forward and backward against their plain
    versions, by default at the flagship's B=32, H=64, D=8, N=64 and 280.
    bf16 runs the tensor-core route (its forward also returns the row
    stats, its backward is one launch from out and the stats); fp32 the row
    kernels.  Beside the bf16 route's device times: the row kernels at the
    same bf16 inputs (the route it replaced) and SDPA with the bias as a
    float attn_mask, a partial yardstick only (it writes no logits and takes
    no logits cotangent)."""
    import torch

    from mmdti_tpu_torch.ops import dropout as drop
    from mmdti_tpu_torch.ops import hopper_attention as ha

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    precisions = (("fp32", torch.float32), ("bf16", torch.bfloat16))
    for N in Ns:
        lens = _padded_lengths(gen, B, N)
        pad = (torch.arange(N)[None, :] >= lens[:, None]).to(dev)
        q, k, v, g_out = (randn(B, N, H * D) for _ in range(4))
        bias = randn(B, H, N, N).masked_fill(pad[:, None, None, :], float("-inf"))
        g_logits = randn(B, H, N, N)
        kf = float(drop.keep_mask(int(seed), DROPOUT, B, H, N, N, device=dev).float().mean())
        for prec, dt in precisions:
            s, p = BYTES[prec], BYTES[prec]
            mma = prec == "bf16"
            args = [t.to(dt).contiguous() for t in (q, k, v, bias)]
            go = g_out.to(dt)
            fwd_bound = _bound(4 * B * N * H * D * s + 2 * B * H * N * N * p,
                               4 * B * H * N * N * D, prec)
            case = f"B={B} N={N} H={H} D={D}"
            for rate in (0.0, DROPOUT):
                sd = seed if rate else None

                def fwd():
                    return ha.pair_bias_attention_cuda(*args, H, sd, rate)

                def plain_fwd():
                    return ha.pair_bias_attention_plain(*args, H, dt, sd, rate)

                out, logits, stats = fwd()
                want_o, want_l, want_s = plain_fwd()
                torch.cuda.synchronize()
                errs = {}
                for what, got, want in (("out", out, want_o), ("logits", logits, want_l)):
                    atol, rtol = TOL[prec][what]
                    e, ok = _err(got, want, atol, rtol)
                    errs[what] = (e, atol if not rtol else [atol, rtol], ok)
                if mma:
                    errs.update(_pair_stats_errs(logits, stats, want_s))
                ms = _time_ms(fwd)
                pms = _time_ms(plain_fwd, iters=10)
                extra = {"route": ha.pair_bias_route(dt, dt)}
                if rate:
                    extra.update(keep_fraction=kf, keep_expected=1 - DROPOUT)
                if mma:
                    rows = _PairRows(*args, logits, go, g_logits.to(dt), H, sd, rate)
                    sdpa = _PairSdpa(*args, go, rate)
                    with torch.no_grad():
                        extra.update(device_ms=_device_ms(fwd), rows_device_ms=_device_ms(rows.fwd),
                                     sdpa_device_ms=_device_ms(sdpa.fwd))
                    extra["sdpa_is"] = SDPA_PAIR_IS
                record("pair_bias_attention", f"{case} dropout={rate}", prec, errs, ms, pms, None,
                       fwd_bound, N == 64 and mma and rate > 0, extra)

                for gl in (g_logits.to(dt), None):
                    n_pair = 3 if gl is not None else 2
                    bwd_bound = _bound(7 * B * N * H * D * s + n_pair * B * H * N * N * p,
                                       8 * B * H * N * N * D, prec)
                    # the backward from the plain forward's logits (and out and stats)
                    rest = (go, gl, H, sd, rate)

                    def bwd():
                        return ha.pair_bias_attention_bwd_cuda(*args[:3], want_l, want_o, want_s,
                                                               *rest)

                    def plain_bwd():
                        if mma:
                            return ha.pair_bias_attention_stats_bwd_plain(
                                *args[:3], want_l, want_o, want_s, *rest)
                        return ha.pair_bias_attention_bwd_plain(*args[:3], want_l, *rest)

                    def ours_fwd_bwd():
                        o, lg, st = fwd()
                        return ha.pair_bias_attention_bwd_cuda(*args[:3], lg, o, st, *rest)

                    got = bwd()
                    again = bwd()
                    oracle = ha.pair_bias_attention_bwd_plain(*args[:3], want_l, *rest)
                    torch.cuda.synchronize()
                    names = ("dq", "dk", "dv", "dbias")
                    errs = _grad_errs(names, got, oracle, prec)
                    if mma:
                        errs.update({f"{n}_vs_stats_plain": e for n, e in _grad_errs(
                            names, got, plain_bwd(), prec).items()})
                    bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
                    if not bit_equal:
                        record.failures.append(f"pair_bias_attention_bwd {case} {prec}: "
                                               f"repeated calls differ")
                    ms = _time_ms(bwd)
                    pms = _time_ms(plain_bwd, iters=10)
                    extra = {"route": ha.pair_bias_route(dt, dt), "repeat_bit_equal": bit_equal}
                    if mma:
                        rows = _PairRows(*args, want_l, go, gl, H, sd, rate)
                        extra.update(device_ms=_device_ms(bwd),
                                     fwd_bwd_device_ms=_device_ms(ours_fwd_bwd),
                                     rows_device_ms=_device_ms(rows.bwd),
                                     rows_fwd_bwd_device_ms=_device_ms(rows.fwd_bwd),
                                     sdpa_fwd_bwd_device_ms=_device_ms(
                                         _PairSdpa(*args, go, rate).fwd_bwd),
                                     sdpa_is=SDPA_PAIR_IS)
                    record("pair_bias_attention_bwd",
                           f"{case} dropout={rate} g_logits={gl is not None}", prec, errs, ms,
                           pms, None, bwd_bound, N == 64 and mma and rate > 0 and gl is not None,
                           extra)


def phase_kernels(dev):
    """Each kernel vs its plain version; returns per-kernel summaries."""
    import torch
    import torch.nn.functional as F

    from mmdti_tpu_torch.ops import dropout as drop
    from mmdti_tpu_torch.ops import hopper_attention as ha
    from mmdti_tpu_torch.ops import hopper_gbf as hg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(1234)
    seed = torch.tensor([20261016], dtype=torch.int32, device=dev)
    record = _Recorder()
    precisions = (("fp32", torch.float32), ("bf16", torch.bfloat16))

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def keep_fraction(B, H, Nq, Nk):
        return float(drop.keep_mask(int(seed), DROPOUT, B, H, Nq, Nk, device=dev).float().mean())

    _pair_bias_cases(dev, gen, seed, record)

    # ---- fused Gaussian + gbf_proj: B=32, K=Kh=128, H=64 -------------------
    B, K, Hh = 32, 128, 64
    means = torch.rand(K, generator=gen).mul(3).to(dev)
    stds = torch.rand(K, generator=gen).mul(3).to(dev)
    w1, w2 = randn(K, K) * 0.02, randn(Hh, K) * 0.02
    b1, b2 = randn(K) * 0.02, randn(Hh) * 0.02
    std = stds.abs() + 1e-5
    for N in (64, 280):
        lens = _padded_lengths(gen, B, N)
        pad = (torch.arange(N)[None, :] >= lens[:, None]).to(dev)
        u = (torch.rand(B, N, N, generator=gen) * 6).to(dev)
        g = randn(B, Hh, N, N)
        P = B * N * N
        for prec, dt in precisions:
            args = (u, means, stds, w1, b1, w2, b2, pad)
            kw = dict(activation="gelu_tanh", pair_dtype=dt, compute_dtype=dt)
            got = hg.gbf_pair_bias_fused(*args, **kw)
            want = hg.gbf_pair_bias_plain(*args, **kw)
            torch.cuda.synchronize()
            atol, rtol = TOL[prec]["out"]
            e, ok = _err(got, want, atol, rtol)
            ms = _time_ms(lambda: hg.gbf_pair_bias_fused(*args, **kw))
            pms = _time_ms(lambda: hg.gbf_pair_bias_plain(*args, **kw), iters=10)
            extra = {"device_ms": _device_ms(lambda: hg.gbf_pair_bias_fused(*args, **kw))}
            record("gbf_proj", f"B={B} N={N} K={K} H={Hh}", prec, {"out": (e, atol, ok)}, ms,
                   pms, None, _bound(P * (4 + Hh * BYTES[prec]), 2 * P * (K * K + K * Hh), prec),
                   N == 64 and prec == "bf16", extra)
            bargs = (u, means, std, w1, b1, w2, g.to(dt), pad, "gelu_tanh", dt)
            got = hg.gbf_pair_bias_bwd_cuda(*bargs)
            want = hg.gbf_pair_bias_bwd_plain(*bargs)
            torch.cuda.synchronize()
            errs = _grad_errs(("du", "dmeans", "dstd", "dw1", "db1", "dw2", "db2"), got, want,
                              prec)
            ms = _time_ms(lambda: hg.gbf_pair_bias_bwd_cuda(*bargs))
            pms = _time_ms(lambda: hg.gbf_pair_bias_bwd_plain(*bargs), iters=10)
            extra = {"device_ms": _device_ms(lambda: hg.gbf_pair_bias_bwd_cuda(*bargs))}
            record("gbf_proj_bwd", f"B={B} N={N} K={K} H={Hh} padded keys", prec, errs, ms, pms,
                   None, _bound(P * (8 + Hh * BYTES[prec]), 2 * P * (3 * K * K + 2 * K * Hh),
                                prec), N == 64 and prec == "bf16", extra)

    # ---- masked attention: ChemBERTa (H=8, D=64) and cross-modal (H=16, D=32)
    # bf16 runs the tensor-core route (its forward also returns the row
    # stats, and its backward starts from out and the stats); fp32 the row
    # kernels.  Both backwards are also held to the recompute oracle.
    cases = [
        ("chemberta", 8, 64, 64, 64, torch.finfo(torch.float32).min),
        ("chemberta", 8, 64, 512, 512, torch.finfo(torch.float32).min),
        ("crossmodal", 16, 32, 64, 64, -10000.0),
        ("crossmodal", 16, 32, 280, 512, -10000.0),
    ]
    for label, Hm, Dm, Nq, Nk, fill in cases:
        lens = _padded_lengths(gen, B, Nk)
        mask = ((torch.arange(Nk)[None, :] >= lens[:, None]).float() * fill).to(dev)
        q, g_out = randn(B, Nq, Hm * Dm), randn(B, Nq, Hm * Dm)
        k, v = randn(B, Nk, Hm * Dm), randn(B, Nk, Hm * Dm)
        kf = keep_fraction(B, Hm, Nq, Nk)
        main_shape = label == "chemberta" and Nq == 64
        for prec, dt in precisions:
            s = BYTES[prec]
            mma = prec == "bf16"
            args = [t.to(dt).contiguous() for t in (q, k, v)] + [mask]
            go = g_out.to(dt)
            leaves = [t.detach().clone().requires_grad_() for t in args[:3]]
            heads = [t.view(B, -1, Hm, Dm).transpose(1, 2) for t in leaves]
            go_heads = go.view(B, Nq, Hm, Dm).transpose(1, 2)
            sdpa_mask = mask.to(dt)[:, None, None, :]
            tokens = 2 * B * Nq * Hm * Dm + 2 * B * Nk * Hm * Dm
            # backward bytes: the function's own, q, g_out, dq and k, v, dk, dv
            # and the mask (not the out and row stats the mma route reads)
            bwd_bytes = (2 * tokens - B * Nq * Hm * Dm) * s + 4 * B * Nk
            case = f"{label} B={B} Nq={Nq} Nk={Nk} H={Hm} D={Dm}"
            for rate in (0.0, DROPOUT):
                sd = seed if rate else None

                def fwd():
                    return ha.masked_attention_cuda(*args, Hm, sd, rate)

                def plain_fwd():
                    return ha.masked_attention_plain(*args, Hm, sd, rate)

                def sdpa():
                    return F.scaled_dot_product_attention(*heads, attn_mask=sdpa_mask,
                                                          dropout_p=rate)

                def sdpa_fwd_bwd():
                    return torch.autograd.grad(sdpa(), leaves, go_heads)

                got, stats = fwd()
                want, want_stats = plain_fwd()
                torch.cuda.synchronize()
                atol, rtol = TOL[prec]["out"]
                e, ok = _err(got, want, atol, rtol)
                errs = {"out": (e, atol, ok)}
                if mma:   # the row stats: guarded max (abs) and 1/rowsum (rel)
                    e, ok = _err(stats[..., 0], want_stats[..., 0], 1e-3, 0.0)
                    errs["stats_max"] = (e, 1e-3, ok)
                    rel = float(((stats[..., 1] - want_stats[..., 1]).abs()
                                 / want_stats[..., 1]).max())
                    errs["stats_inv_rel"] = (rel, 1e-3, rel <= 1e-3)
                ms = _time_ms(fwd)
                pms = _time_ms(plain_fwd, iters=10)
                with torch.no_grad():
                    lms = _time_ms(sdpa)
                extra = {"route": ha.masked_route(dt)}
                if rate:
                    extra.update(keep_fraction=kf, keep_expected=1 - DROPOUT)
                if mma:
                    with torch.no_grad():
                        extra.update(device_ms=_device_ms(fwd), library_device_ms=_device_ms(sdpa))
                record("masked_attention", f"{case} dropout={rate}", prec, errs, ms, pms, lms,
                       _bound(tokens * s + 4 * B * Nk, 4 * B * Hm * Nq * Nk * Dm, prec),
                       main_shape and mma and rate > 0, extra)

                # the backward from the plain forward's out and stats
                bargs = (*args, want, want_stats, go, Hm, sd, rate)

                def bwd():
                    return ha.masked_attention_bwd_cuda(*bargs)

                def plain_bwd():
                    if mma:
                        return ha.masked_attention_stats_bwd_plain(*bargs)
                    return ha.masked_attention_bwd_plain(*args, go, Hm, sd, rate)

                def ours_fwd_bwd():
                    o, st = fwd()
                    return ha.masked_attention_bwd_cuda(*args, o, st, go, Hm, sd, rate)

                got = bwd()
                again = bwd()
                oracle = ha.masked_attention_bwd_plain(*args, go, Hm, sd, rate)
                torch.cuda.synchronize()
                errs = _grad_errs(("dq", "dk", "dv"), got, oracle, prec)
                if mma:
                    errs.update({f"{n}_vs_stats_plain": e for n, e in _grad_errs(
                        ("dq", "dk", "dv"), got, plain_bwd(), prec).items()})
                bit_equal = all(torch.equal(x, y) for x, y in zip(got, again))
                if not bit_equal:
                    record.failures.append(f"masked_attention_bwd {case} {prec}: repeated "
                                           f"calls differ")
                ms = _time_ms(bwd)
                pms = _time_ms(plain_bwd, iters=10)
                lms = _time_ms(sdpa_fwd_bwd)
                extra = {"route": ha.masked_route(dt), "repeat_bit_equal": bit_equal,
                         "fwd_bwd_ms": _time_ms(ours_fwd_bwd),
                         "library_is": "SDPA forward + autograd backward"}
                if mma:
                    extra.update(device_ms=_device_ms(bwd),
                                 fwd_bwd_device_ms=_device_ms(ours_fwd_bwd),
                                 library_device_ms=_device_ms(sdpa_fwd_bwd))
                record("masked_attention_bwd", f"{case} dropout={rate}", prec, errs, ms, pms,
                       lms, _bound(bwd_bytes, 10 * B * Hm * Nq * Nk * Dm, prec),
                       main_shape and mma and rate > 0, extra)
    _layer_norm_cases(dev, gen, record)
    if record.failures:
        raise Failed("kernel mismatch: " + "; ".join(record.failures))
    return record.summary


def _layer_norm_cases(dev, gen, record):
    """LayerNorm forward and backward against their plain versions; the
    library yardstick is F.layer_norm in x's dtype (its variance is the
    two-pass one), forward alone and forward plus backward."""
    import torch
    import torch.nn.functional as F

    from mmdti_tpu_torch.ops import hopper_ln as hl

    dts = (("fp32", torch.float32), ("bf16", torch.bfloat16))
    E = 512
    for T in (2048, 8960):      # B=32 at N=64 and at the top atom bucket N=280
        x0 = torch.randn(T, E, generator=gen).to(dev)
        gy0 = torch.randn(T, E, generator=gen).to(dev)
        w = (torch.rand(E, generator=gen) + 0.5).to(dev)
        b = (torch.randn(E, generator=gen) * 0.1).to(dev)
        for xp, xd in dts:
            x = x0.to(xd)
            for yp, yd in dts:
                gy = gy0.to(yd)
                coarse = "bf16" if "bf16" in (xp, yp) else "fp32"
                for eps in (1e-5, 1e-12):
                    case = f"T={T} E={E} x={xp} y={yp} eps={eps}"
                    main = T == 2048 and xp == yp == "bf16" and eps == 1e-5
                    y = hl.layer_norm_cuda(x, w, b, eps, yd)
                    want = hl.layer_norm_plain(x, w, b, eps, yd)
                    torch.cuda.synchronize()
                    atol, rtol = LN_FWD_TOL[yp]
                    e, ok = _err(y, want, atol, rtol)
                    ms = _time_ms(lambda: hl.layer_norm_cuda(x, w, b, eps, yd))
                    pms = _time_ms(lambda: hl.layer_norm_plain(x, w, b, eps, yd), iters=10)
                    wl, bl = w.to(xd), b.to(xd)
                    lms = _time_ms(lambda: F.layer_norm(x, (E,), wl, bl, eps))
                    sx, sy = BYTES[xp], BYTES[yp]
                    dev_ms = {}
                    if eps == 1e-5:
                        dev_ms = {
                            "device_ms": _device_ms(lambda: hl.layer_norm_cuda(x, w, b, eps, yd)),
                            "plain_device_ms": _device_ms(
                                lambda: hl.layer_norm_plain(x, w, b, eps, yd)),
                            "library_device_ms": _device_ms(
                                lambda: F.layer_norm(x, (E,), wl, bl, eps))}
                    record("layer_norm", case, f"x {xp} y {yp}", {"y": (e, [atol, rtol], ok)}, ms,
                           pms, lms,
                           _bound(T * E * (sx + sy) + 2 * E * 4, 8 * T * E, "fp32"), main,
                           dev_ms)

                    got = hl.layer_norm_bwd_cuda(x, w, gy, eps)
                    again = hl.layer_norm_bwd_cuda(x, w, gy, eps)
                    ref = hl.layer_norm_bwd_plain(x, w, gy, eps)
                    torch.cuda.synchronize()
                    errs = {}
                    for name, g, r in zip(("dx", "dscale", "dbias"), got, ref):
                        gtol = LN_FWD_TOL[coarse][0] * max(1.0, float(r.float().abs().max()))
                        e, ok = _err(g, r, gtol, 0.0)
                        errs[name] = (e, gtol, ok)
                    bit_equal = all(torch.equal(g, a) for g, a in zip(got, again))
                    if not bit_equal:
                        record.failures.append(f"layer_norm_bwd {case}: repeated calls differ")
                    ms = _time_ms(lambda: hl.layer_norm_bwd_cuda(x, w, gy, eps))
                    pms = _time_ms(lambda: hl.layer_norm_bwd_plain(x, w, gy, eps), iters=10)
                    xr, wr, br = (t.detach().clone().requires_grad_() for t in (x, wl, bl))
                    gyx = gy.to(xd)
                    lms = _time_ms(lambda: torch.autograd.grad(
                        F.layer_norm(xr, (E,), wr, br, eps), (xr, wr, br), gyx))

                    def ours_fwd_bwd():
                        hl.layer_norm_cuda(x, w, b, eps, yd)
                        hl.layer_norm_bwd_cuda(x, w, gy, eps)

                    extra = {"repeat_bit_equal": bit_equal, "fwd_bwd_ms": _time_ms(ours_fwd_bwd),
                             "library_is": "F.layer_norm forward + autograd backward"}
                    if eps == 1e-5:
                        extra.update(
                            device_ms=_device_ms(lambda: hl.layer_norm_bwd_cuda(x, w, gy, eps)),
                            fwd_bwd_device_ms=_device_ms(ours_fwd_bwd),
                            plain_device_ms=_device_ms(
                                lambda: hl.layer_norm_bwd_plain(x, w, gy, eps)),
                            library_device_ms=_device_ms(lambda: torch.autograd.grad(
                                F.layer_norm(xr, (E,), wr, br, eps), (xr, wr, br), gyx)))
                    record("layer_norm_bwd", case, f"x {xp} y {yp}", errs, ms, pms, lms,
                           _bound(T * E * (2 * sx + sy) + 3 * E * 4, 14 * T * E, "fp32"), main,
                           extra)


def phase_serve(dev):
    """Flagship MolServe on the card: p50 per request size, launch counts,
    logits against the plain path on the same weights."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolServe
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.models.mm_model import build_model

    cfg = {"task": "regression", "compute_dtype": "bfloat16"}  # flagship widths
    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)
    model = build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size)
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    n_params = sum(p.numel() for p in model.parameters())
    server = MolServe(cfg, sd, device=dev)
    plain = MolServe(cfg, sd, device=dev, use_kernels=False)
    del model

    requests = {n: SMILES_20[:n] for n in REQUESTS}
    cold_ms = {}
    for n, smi in requests.items():  # first answer: featurize + first launches
        t0 = time.perf_counter()
        server.predict(smi)
        cold_ms[n] = (time.perf_counter() - t0) * 1e3

    _reset_counts()
    lat, outs = {}, {}
    for n, smi in requests.items():
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            outs[n] = server.predict(smi)
            times.append((time.perf_counter() - t0) * 1e3)
        lat[n] = statistics.median(times)
    launches, routes = _read_counts(), _read_routes()

    forwards = REPEATS * len(REQUESTS)
    ucfg = server.model.unimol_cfg
    attn = _attention_launches(ucfg.encoder_layers, server.model.bert.cfg.num_hidden_layers
                               + 2 * server.model.cross_modal_module.text_attention.cfg.num_layers,
                               backward=False)
    per_fwd = {"gbf_proj": 1, **attn,
               "gbf_proj_bwd": 0, "pair_bias_attention_bwd": 0, "masked_attention_bwd": 0}
    for n, out in outs.items():
        if out["predict"].shape != (n, 1) or not np.isfinite(out["predict"]).all():
            raise Failed(f"predict({n}) gave {out['predict']!r}")

    # kernel path vs plain path, same weights, same collated 20-SMILES batch
    feats, n = server._device_feats(server._featurize(requests[20]))
    with torch.inference_mode():
        got = server.model(**feats, outputs="logits")["logits"][:n]
        want = plain.model(**feats, outputs="logits")["logits"][:n]
    diff = float((got - want).abs().max())
    plain_pred = plain.predict(requests[20])["predict"]
    pred_diff = float(np.abs(outs[20]["predict"] - plain_pred).max())

    print(f"serve: flagship {n_params} params, layers={ucfg.encoder_layers} "
          f"E={ucfg.embed_dim} H={ucfg.attention_heads}, compute bf16, pair {ucfg.pair_dtype}",
          flush=True)
    print("serve: " + json.dumps({
        "p50_ms": {str(k): v for k, v in lat.items()},
        "cold_first_request_ms": {str(k): v for k, v in cold_ms.items()},
        "repeats": REPEATS, "forwards": forwards, "launches": launches,
        "launches_per_forward_expected": per_fwd, "attention_routes": routes,
        "logits_max_abs_diff_vs_plain": diff, "predict_max_abs_diff_vs_plain": pred_diff,
        "logits_tol": LOGITS_TOL,
    }), flush=True)
    for k, per in per_fwd.items():
        if launches[k] != per * forwards:
            raise Failed(f"serve {k}: {launches[k]} launches, expected {per} x {forwards}")
    _check_mma_routes(routes, {k: n * forwards for k, n in attn.items()}, "serve")
    if not (diff <= LOGITS_TOL and pred_diff <= LOGITS_TOL):
        raise Failed(f"kernel path differs from plain path: logits {diff}, predict {pred_diff}")
    return launches


def _train_batch(dev, atom_pad, smiles_pad, B=32):
    """B molecules of SMILES_20 featurized (host conformers) and collated to
    N=atom_pad atoms and L=smiles_pad tokens, on the device."""
    import numpy as np
    import torch

    from mmdti_tpu_torch.chem.conformer import ConformerGen
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.data.batching import BatchCollator

    smiles = (SMILES_20 * (B // len(SMILES_20) + 1))[:B]
    conf = ConformerGen()
    feats = conf.transform(smiles)
    for f, s in zip(feats, smiles):
        f["smile"] = s
    coll = BatchCollator(SmilesTokenizer(), pad_idx=conf.dictionary.pad(), pad_mode="fixed",
                         atom_pad=atom_pad, smiles_pad=smiles_pad)
    batch, _ = coll([(f, np.zeros(1, np.float32)) for f in feats])
    keys = ("src_tokens", "src_distance", "src_edge_type", "input_ids", "attention_mask")
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev) for k in keys}


def _profile_steps(step, args, n=3):
    """torch.profiler over n train steps: device time per step, kernels per
    step, the share of the port's own kernels, the top kernels by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in kernels)
    ours = ("attention_rows_kernel", "attention_bwd_rows_kernel", "attention_bwd_cols_kernel",
            "gbf_proj_kernel", "gbf_proj_bwd_kernel", "gbf_bwd_reduce_kernel", "masked_mma_",
            "pair_mma_")

    def device_us(*names):
        return sum(e.self_device_time_total for e in kernels if any(o in e.key for o in names))

    own_us, masked_us, pair_us = device_us(*ours), device_us("masked_mma_"), device_us("pair_mma_")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "steps": n,
        "device_ms_per_step": total_us / n / 1e3,
        "kernel_launches_per_step": sum(e.count for e in kernels) / n,
        "port_kernels_ms_per_step": own_us / n / 1e3,
        "masked_mma_kernels_ms_per_step": masked_us / n / 1e3,
        "pair_mma_kernels_ms_per_step": pair_us / n / 1e3,
        "top_kernels": [{"name": e.key[:90], "ms_per_step": e.self_device_time_total / n / 1e3,
                         "calls_per_step": e.count / n} for e in top],
    }


def _profile_optimizer(opt):
    """Kernel launches and wall time of one clip + Adam update, taken with
    zero gradients (the momentum still moves the parameters, as a step
    would)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    grads = {n: torch.zeros_like(p) for n, p in opt.params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.apply(grads)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt.apply(grads)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"parameter_tensors": len(opt.params), "kernel_launches": launches,
            "wall_ms": host_ms}


def phase_train(dev):
    """The flagship train step on the card; returns the launch counts of
    the 30-step run."""
    import torch

    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.losses import zoo
    from mmdti_tpu_torch.models.mm_model import build_model
    from mmdti_tpu_torch.train.optim import FusedAdam
    from mmdti_tpu_torch.train.steps import build_train_loss, build_train_step

    d = Dictionary.load()
    d.add_symbol("[MASK]", is_special=True)

    def flagship(use_kernels):
        return build_model(1, len(d), d.pad(), SmilesTokenizer().vocab_size,
                           compute_dtype="bfloat16", use_kernels=use_kernels,
                           unimol_overrides={"pair_dtype": "bfloat16"})

    model = flagship(True)
    model.reset_parameters_like_flax(torch.Generator().manual_seed(0))
    plain = flagship(False)
    plain.load_state_dict(model.state_dict())
    model.to(dev)
    plain.to(dev)
    B = 32
    feats = _train_batch(dev, 64, 64, B)
    labels = torch.randn(B, 1, generator=torch.Generator().manual_seed(1)).to(dev)
    weights = torch.ones(B, 1, device=dev)
    ucfg = model.unimol_cfg
    n_masked = model.bert.cfg.num_hidden_layers + 2 * model.cross_modal_module.cfg.num_layers
    print(f"train: flagship layers={ucfg.encoder_layers} E={ucfg.embed_dim} "
          f"H={ucfg.attention_heads} K={ucfg.gaussian_kernels}, bf16 compute, pair "
          f"{ucfg.pair_dtype}, batch B={B} N={feats['src_tokens'].shape[1]} "
          f"L={feats['input_ids'].shape[1]}, regression MSE + 0.1 InfoNCE + 0.1 ct_regress",
          flush=True)

    # (a) one step's loss and gradients, dropout off, kernel vs plain path,
    # at N=L=64 and at the top SMILES bucket L=512 (N=64)
    train_loss = build_train_loss(zoo.mse_loss, "regression")
    feats512 = _train_batch(dev, 64, 512, B)
    attn = _attention_launches(ucfg.encoder_layers, n_masked)
    _compare_paths(model, plain, train_loss, feats, labels, weights, attn)
    _compare_paths(model, plain, train_loss, feats512, labels, weights, attn)
    del plain

    # (b) 30 steps, dropout on, one fixed batch; (c) their times and launches
    opt = FusedAdam(dict(model.named_parameters()), 1e-4, TRAIN_STEPS, warmup_ratio=0.1,
                    max_norm=1.0)
    step = build_train_step(model, opt, zoo.mse_loss, "regression")
    gen = torch.Generator(device=dev).manual_seed(7)
    _reset_counts()
    losses, events = [], []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(step(feats, labels, weights, gen)["loss"])
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _read_counts()
    routes = _read_routes()
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in events]
    p50 = statistics.median(step_ms)
    per_step = {"gbf_proj": 1, "gbf_proj_bwd": 1, **attn}
    print("train: " + json.dumps({
        "steps": TRAIN_STEPS, "dropout": "on", "first_loss": losses[0], "last_loss": losses[-1],
        "losses": losses, "step_ms_p50": p50, "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "mols_per_s": B / p50 * 1e3,
        "host_wall_s": wall_s, "launches": launches, "launches_per_step_expected": per_step,
        "attention_routes": routes,
    }), flush=True)
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise Failed(f"train: non-finite loss in {losses}")
    if not losses[-1] < losses[0]:
        raise Failed(f"train: loss did not fall: first {losses[0]}, last {losses[-1]}")
    for k, per in per_step.items():
        if launches[k] != per * TRAIN_STEPS:
            raise Failed(f"train {k}: {launches[k]} launches, expected {per} x {TRAIN_STEPS}")
    _check_mma_routes(routes, {k: n * TRAIN_STEPS for k, n in attn.items()}, "train")
    print("train: profile " + json.dumps(_profile_steps(step, (feats, labels, weights, gen))),
          flush=True)
    print("train: optimizer " + json.dumps(_profile_optimizer(opt)), flush=True)

    # (d) one step at the top atom bucket
    feats280 = _train_batch(dev, 280, 64, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    loss280 = float(step(feats280, labels, weights, gen)["loss"])
    b.record()
    torch.cuda.synchronize()
    peak280 = torch.cuda.max_memory_allocated(dev)
    print("train: " + json.dumps({
        "step": "top atom bucket", "B": B, "N": 280, "L": 64, "loss": loss280,
        "step_ms": a.elapsed_time(b), "max_memory_allocated_bytes": peak280,
        "profile": _profile_steps(step, (feats280, labels, weights, gen), n=2),
    }), flush=True)
    if not loss280 == loss280 or abs(loss280) == float("inf"):
        raise Failed(f"train: N=280 step gave loss {loss280}")

    # (e) one step at the top SMILES bucket L=512 (N=64): launches per
    # route, device time and the masked kernels' share of it, peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    loss512 = float(step(feats512, labels, weights, gen)["loss"])
    b.record()
    torch.cuda.synchronize()
    counts512, routes512 = _read_counts(), _read_routes()
    peak512 = torch.cuda.max_memory_allocated(dev)
    prof512 = _profile_steps(step, (feats512, labels, weights, gen), n=2)
    print("train: " + json.dumps({
        "step": "top SMILES bucket", "B": B, "N": 64, "L": 512, "loss": loss512,
        "step_ms": a.elapsed_time(b), "max_memory_allocated_bytes": peak512,
        "masked_launches": {k: counts512[k] for k in ("masked_attention",
                                                      "masked_attention_bwd")},
        "attention_routes": routes512, "profile": prof512,
    }), flush=True)
    if not loss512 == loss512 or abs(loss512) == float("inf"):
        raise Failed(f"train: L=512 step gave loss {loss512}")
    _check_mma_routes(routes512, attn, "train L=512")
    return launches


def _check_mma_routes(routes, expected, what):
    """Every attention launch of a bf16 run went to the tensor-core route:
    expected maps a launcher to its number of launches."""
    for k, n in expected.items():
        if routes[k] != {"mma": n, "rows": 0}:
            raise Failed(f"{what} {k}: routes {routes[k]}, expected {n} on mma")


def _attention_launches(n_pair, n_masked, backward=True):
    """Launches per attention launcher of one forward (and backward)."""
    per = {"pair_bias_attention": n_pair, "masked_attention": n_masked}
    if backward:
        per.update(pair_bias_attention_bwd=n_pair, masked_attention_bwd=n_masked)
    return per


def _compare_paths(model, plain, train_loss, feats, labels, weights, attn):
    """One step's loss and gradients, dropout off, on the kernel path
    against the plain path; the kernel path's attention launches (attn:
    launcher -> count) must all take the tensor-core route."""
    import torch

    def loss_and_grads(m):
        total, _ = train_loss(m, feats, labels, weights, None)
        names, params = zip(*m.named_parameters())
        return float(total.detach()), dict(zip(names, torch.autograd.grad(total, params)))

    _reset_counts()
    lk, gk = loss_and_grads(model)
    routes = _read_routes()
    lp, gp = loss_and_grads(plain)
    # each parameter's largest difference over its gradient's max, floored
    # at 1e-3 of the whole gradient's max: a gradient that is zero in exact
    # arithmetic (the attention key biases') holds only rounding noise
    floor = 1e-3 * max(float(g.float().abs().max()) for g in gp.values())
    rel = {}
    for name, g in gp.items():
        if not torch.isfinite(gk[name]).all():
            raise Failed(f"train: kernel-path gradient of {name} is not finite")
        scale = max(float(g.float().abs().max()), floor)
        rel[name] = float((gk[name].float() - g.float()).abs().max()) / scale
    worst = max(rel, key=rel.get)
    shape = {"N": feats["src_tokens"].shape[1], "L": feats["input_ids"].shape[1]}
    print("train: " + json.dumps({
        "check": "kernel vs plain path, dropout off", **shape, "loss_kernel": lk,
        "loss_plain": lp, "loss_abs_diff": abs(lk - lp), "loss_tol": TRAIN_LOSS_TOL,
        "max_rel_grad_diff": rel[worst], "worst_param": worst,
        "median_rel_grad_diff": statistics.median(rel.values()), "grad_tol": TRAIN_GRAD_TOL,
        "attention_routes": routes,
    }), flush=True)
    if not (abs(lk - lp) <= TRAIN_LOSS_TOL and rel[worst] <= TRAIN_GRAD_TOL):
        raise Failed(f"train {shape}: kernel path differs from plain path: loss {lk} vs {lp}, "
                     f"{worst} grad rel diff {rel[worst]}")
    _check_mma_routes(routes, attn, f"train {shape} check")


def phase_fit(dev):
    """MolTrain.fit -> MolPredict at the flagship width and depth with the
    LayerNorm kernels engaged; returns the launch counts of the phase."""
    import shutil

    import numpy as np
    import torch

    from mmdti_tpu_torch import MolPredict, MolTrain
    from mmdti_tpu_torch.chem.conformer import ConformerGen
    from mmdti_tpu_torch.data.reader import read_csv, write_csv
    from mmdti_tpu_torch.finetune import make_synthetic_dataset
    from mmdti_tpu_torch.models.layers import FusedLN
    from mmdti_tpu_torch.splits import random_scaffold_split

    work = os.path.join(REPO, "build", "chip_smoke_fit")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    data = os.path.join(work, "synthetic.csv")
    make_synthetic_dataset(data, n=FIT_MOLECULES, seed=0)
    paths = {}
    for name, table in zip(("train", "val", "test"), random_scaffold_split(data, 0)):
        paths[name] = os.path.join(work, f"{name}.csv")
        write_csv(table, paths[name])
    sizes = {k: len(read_csv(p)["smiles"]) for k, p in paths.items()}
    t0 = time.perf_counter()
    ConformerGen().transform(list(read_csv(data)["smiles"]))
    featurize_s = time.perf_counter() - t0
    print(f"fit: {FIT_MOLECULES} molecules, split {sizes}; host featurization of all of them "
          f"{featurize_s:.2f} s (the fit and each predict featurize their sets again)",
          flush=True)

    exp = os.path.join(work, "exp")
    previous = os.environ.get("MMDTI_PALLAS_LN")
    os.environ["MMDTI_PALLAS_LN"] = "1"
    try:
        _reset_counts()
        t0 = time.perf_counter()
        clf = MolTrain(task="regression", epochs=FIT_EPOCHS, learning_rate=1e-4, batch_size=32,
                       early_stopping=20, metrics="mse", smiles_col="smiles", save_path=exp,
                       target_cols=["measured"], using_infonce=True, using_ct=True,
                       raw_data=paths["train"], seed=42, use_weight=True, fds=True, fds_num=30,
                       fds_raw_path=paths["train"], fds_col_data="measured",
                       target_anomaly_check="filter", device=dev.type)
        clf.fit(paths["train"], paths["val"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_counts = _read_counts()
        test_pred = MolPredict(load_model=exp).predict(paths["test"],
                                                      save_path=os.path.join(work, "out"))
        launches = _read_counts()
        val_pred = MolPredict(load_model=exp).predict(paths["val"])
        plain = MolPredict(load_model=exp)
        plain.config["use_pallas"] = False
        val_plain = plain.predict(paths["val"])
    finally:
        if previous is None:
            os.environ.pop("MMDTI_PALLAS_LN")
        else:
            os.environ["MMDTI_PALLAS_LN"] = previous

    model = clf.model.model
    ucfg = model.unimol_cfg
    per_forward = sum(1 for m in model.modules()
                      if isinstance(m, FusedLN) and m.use_kernels and m.weight.numel() % 128 == 0)
    steps = sizes["train"] // 32
    with open(os.path.join(exp, "history_0.json")) as f:
        history = json.load(f)
    epochs_run = len(history)
    train_steps = steps * epochs_run
    truth = np.asarray(read_csv(paths["test"])["measured"], np.float64)
    rmse = float(np.sqrt(np.mean((truth - test_pred.reshape(-1)) ** 2)))
    reload_diff = float(np.abs(val_pred - clf.cv_pred).max())
    plain_diff = float(np.abs(val_pred - val_plain).max())
    print("fit: " + json.dumps({
        "model": {"layers": ucfg.encoder_layers, "E": ucfg.embed_dim, "H": ucfg.attention_heads,
                  "compute": "bf16", "pair": ucfg.pair_dtype, "batch": 32},
        "epochs": epochs_run, "steps_per_epoch": steps, "fit_wall_s": fit_s,
        "epoch_wall_s": [row["seconds"] for row in history],
        "epoch_val_s": [row["val_seconds"] for row in history],
        "val_mse": [row["val_mse"] for row in history],
        "layer_norms_per_forward": per_forward,
        "fit_launches": {k: fit_counts[k] for k in ("layer_norm", "layer_norm_bwd",
                                                    "layer_norm_bwd_reduce")},
        "fit_ln_backward_per_step": fit_counts["layer_norm_bwd"] / train_steps,
        "fit_ln_forward_per_step_incl_eval": fit_counts["layer_norm"] / train_steps,
        "artifacts": sorted(os.listdir(exp)),
        "predict_files": sorted(os.listdir(os.path.join(work, "out"))),
        "reload_vs_fit_max_abs_diff": reload_diff,
        "kernel_vs_plain_max_abs_diff": plain_diff, "plain_tol": LOGITS_TOL,
        "test_rmse_seed0": rmse,
    }), flush=True)
    if reload_diff != 0.0:
        raise Failed(f"fit: MolPredict's reload differs from the fit's predictions by "
                     f"{reload_diff}")
    if not plain_diff <= LOGITS_TOL:
        raise Failed(f"fit: kernel path differs from plain path by {plain_diff}")
    if not np.isfinite(test_pred).all() or not np.isfinite(rmse):
        raise Failed(f"fit: test predictions not finite (rmse {rmse})")
    want = {"layer_norm_bwd": per_forward * train_steps,
            "layer_norm_bwd_reduce": per_forward * train_steps}
    for k, n in want.items():
        if fit_counts[k] != n:
            raise Failed(f"fit {k}: {fit_counts[k]} launches, expected {n}")
    if fit_counts["layer_norm"] % per_forward or fit_counts["layer_norm"] <= want[
            "layer_norm_bwd"]:
        raise Failed(f"fit layer_norm: {fit_counts['layer_norm']} launches")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "mmdti_tpu_torch")):
        print("chip_smoke.py needs the mmdti_tpu_torch package beside it", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke.py needs torch", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    dev = torch.device("cuda", 0)

    card = phase_card()
    phase_build()
    summary = phase_kernels(dev)
    phase_serve(dev)
    train_launches = phase_train(dev)
    fit_launches = phase_fit(dev)

    launches = {k: train_launches[k] if k in TRAIN_KERNELS else fit_launches[k] for k in KERNELS}
    for name, n in launches.items():
        if n == 0:
            raise Failed(f"{name} was not launched on its path")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **summary[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(card, flush=True)   # again beside the summary, for readers of the tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
