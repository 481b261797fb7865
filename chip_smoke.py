#!/usr/bin/env python3
"""Smoke run of the mmdti_tpu_torch serving slice on one CUDA card (H100).

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the three Hopper kernels from mmdti_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card, fp32 (TF32
   off) and bf16, at the flagship shapes, with padded keys; max error beside
   its tolerance, and the kernel's time beside the plain version's (CUDA
   events, median of 25 launches after warmup);
4. a flagship-width MolServe on the card (weights drawn from a seeded
   torch.Generator) answers requests of 1, 8 and 20 SMILES; prints the
   per-request p50, the kernel launch counts of that run (gbf 1, pair-bias
   15, masked 8 per forward) and the largest logit difference between the
   kernel path and the same weights on the plain path;
5. one JSON line per kernel summary, then {"ok": true, "device": ...}.

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
LOGITS_TOL = 2e-2  # kernel vs plain path, flagship logits (bf16 compute)


class Failed(RuntimeError):
    pass


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
    print(f"build: {len(paths)} kernels in {secs:.1f} s ({_build.BUILD_DIR})", flush=True)
    for name in paths:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            regs = [ln.strip() for ln in f if "registers" in ln]
        print(f"build: {name}: {len(regs)} kernel variants, e.g. {regs[:1]}", flush=True)
    return secs


def _padded_lengths(gen, B, N):
    import torch

    return torch.randint(max(2, N // 2), N + 1, (B,), generator=gen)


def phase_kernels(dev):
    """Each kernel vs its plain version; returns per-kernel summaries."""
    import torch

    from mmdti_tpu_torch.ops import hopper_attention as ha
    from mmdti_tpu_torch.ops import hopper_gbf as hg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cpu").manual_seed(1234)
    summary = {}
    failures = []

    def record(kernel, case, prec, errs, ms, plain_ms, main_shape):
        line = {"kernel": kernel, "case": case, "precision": prec, "ms": ms,
                "plain_ms": plain_ms}
        for what, (err, tol, ok) in errs.items():
            line[f"{what}_max_abs_err"] = err
            line[f"{what}_tol"] = tol
            if not ok:
                failures.append(f"{kernel} {case} {prec} {what}: err {err} tol {tol}")
        print("kernel: " + json.dumps(line), flush=True)
        s = summary.setdefault(kernel, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], *(e for e, _, _ in errs.values()))
        if main_shape and prec == "bf16":
            s["ms"], s["plain_ms"] = ms, plain_ms

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    # ---- pair-bias attention: B=32, H=64, D=8 ----------------------------
    B, H, D = 32, 64, 8
    for N in (64, 280):
        lens = _padded_lengths(gen, B, N)
        pad = (torch.arange(N)[None, :] >= lens[:, None]).to(dev)
        q, k, v = (randn(B, N, H * D) for _ in range(3))
        bias = randn(B, H, N, N).masked_fill(pad[:, None, None, :], float("-inf"))
        for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            args = [t.to(dt).contiguous() for t in (q, k, v, bias)]
            out, logits = ha.pair_bias_attention_cuda(*args, H)
            want_o, want_l = ha.pair_bias_attention_plain(*args, H, dt)
            torch.cuda.synchronize()
            errs = {}
            for what, got, want in (("out", out, want_o), ("logits", logits, want_l)):
                atol, rtol = TOL[prec][what]
                e, ok = _err(got, want, atol, rtol)
                errs[what] = (e, atol if not rtol else [atol, rtol], ok)
            ms = _time_ms(lambda: ha.pair_bias_attention_cuda(*args, H))
            pms = _time_ms(lambda: ha.pair_bias_attention_plain(*args, H, dt))
            record("pair_bias_attention", f"B={B} N={N} H={H} D={D}", prec, errs, ms, pms,
                   N == 64)

    # ---- fused Gaussian + gbf_proj: K=Kh=128, H=64 ------------------------
    K, Hh = 128, 64
    means = torch.rand(K, generator=gen).mul(3).to(dev)
    stds = torch.rand(K, generator=gen).mul(3).to(dev)
    w1, w2 = randn(K, K) * 0.02, randn(Hh, K) * 0.02
    b1, b2 = randn(K) * 0.02, randn(Hh) * 0.02
    for N in (64, 280):
        lens = _padded_lengths(gen, B, N)
        pad = (torch.arange(N)[None, :] >= lens[:, None]).to(dev)
        u = (torch.rand(B, N, N, generator=gen) * 6).to(dev)
        for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            args = (u, means, stds, w1, b1, w2, b2, pad)
            kw = dict(activation="gelu_tanh", pair_dtype=dt, compute_dtype=dt)
            got = hg.gbf_pair_bias_fused(*args, **kw)
            want = hg.gbf_pair_bias_plain(*args, **kw)
            torch.cuda.synchronize()
            atol, rtol = TOL[prec]["out"]
            e, ok = _err(got, want, atol, rtol)
            ms = _time_ms(lambda: hg.gbf_pair_bias_fused(*args, **kw))
            pms = _time_ms(lambda: hg.gbf_pair_bias_plain(*args, **kw))
            record("gbf_proj", f"B={B} N={N} K={K} H={Hh}", prec,
                   {"out": (e, atol, ok)}, ms, pms, N == 64)

    # ---- masked attention: ChemBERTa (H=8, D=64) and cross-modal (H=16, D=32)
    cases = [
        ("chemberta", 8, 64, 64, 64, torch.finfo(torch.float32).min),
        ("chemberta", 8, 64, 512, 512, torch.finfo(torch.float32).min),
        ("crossmodal", 16, 32, 64, 64, -10000.0),
        ("crossmodal", 16, 32, 280, 512, -10000.0),
    ]
    for label, Hm, Dm, Nq, Nk, fill in cases:
        lens = _padded_lengths(gen, B, Nk)
        mask = ((torch.arange(Nk)[None, :] >= lens[:, None]).float() * fill).to(dev)
        q = randn(B, Nq, Hm * Dm)
        k, v = randn(B, Nk, Hm * Dm), randn(B, Nk, Hm * Dm)
        for prec, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            args = [t.to(dt).contiguous() for t in (q, k, v)] + [mask]
            got = ha.masked_attention_cuda(*args, Hm)
            want = ha.masked_attention_plain(*args, Hm)
            torch.cuda.synchronize()
            atol, rtol = TOL[prec]["out"]
            e, ok = _err(got, want, atol, rtol)
            ms = _time_ms(lambda: ha.masked_attention_cuda(*args, Hm))
            pms = _time_ms(lambda: ha.masked_attention_plain(*args, Hm))
            record("masked_attention", f"{label} B={B} Nq={Nq} Nk={Nk} H={Hm} D={Dm}",
                   prec, {"out": (e, atol, ok)}, ms, pms, label == "chemberta" and Nq == 64)
    if failures:
        raise Failed("kernel mismatch: " + "; ".join(failures))
    return summary


def phase_serve(dev):
    """Flagship MolServe on the card: p50 per request size, launch counts,
    logits against the plain path on the same weights."""
    import numpy as np
    import torch

    from mmdti_tpu_torch import MolServe
    from mmdti_tpu_torch.chem.dictionary import Dictionary
    from mmdti_tpu_torch.chem.tokenizer import SmilesTokenizer
    from mmdti_tpu_torch.models.mm_model import build_model
    from mmdti_tpu_torch.ops import hopper_attention as ha
    from mmdti_tpu_torch.ops import hopper_gbf as hg

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

    counters = {"gbf_proj": hg.gbf_pair_bias_cuda,
                "pair_bias_attention": ha.pair_bias_attention_cuda,
                "masked_attention": ha.masked_attention_cuda}
    for c in counters.values():
        c.launches = 0
    lat, outs = {}, {}
    for n, smi in requests.items():
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            outs[n] = server.predict(smi)
            times.append((time.perf_counter() - t0) * 1e3)
        lat[n] = statistics.median(times)
    launches = {k: c.launches for k, c in counters.items()}

    forwards = REPEATS * len(REQUESTS)
    ucfg = server.model.unimol_cfg
    per_fwd = {"gbf_proj": 1, "pair_bias_attention": ucfg.encoder_layers,
               "masked_attention": server.model.bert.cfg.num_hidden_layers
               + 2 * server.model.cross_modal_module.text_attention.cfg.num_layers}
    for n, out in outs.items():
        if out["predict"].shape != (n, 1) or not np.isfinite(out["predict"]).all():
            raise Failed(f"predict({n}) gave {out['predict']!r}")

    # kernel path vs plain path, same weights, same collated 20-SMILES batch
    feats, n = server._device_feats(server._featurize(requests[20]))
    with torch.inference_mode():
        got = server.model(**feats, logits_only=True)["logits"][:n]
        want = plain.model(**feats, logits_only=True)["logits"][:n]
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
        "launches_per_forward_expected": per_fwd,
        "logits_max_abs_diff_vs_plain": diff, "predict_max_abs_diff_vs_plain": pred_diff,
        "logits_tol": LOGITS_TOL,
    }), flush=True)
    for k, per in per_fwd.items():
        if launches[k] != per * forwards:
            raise Failed(f"{k}: {launches[k]} launches, expected {per} x {forwards}")
    if not (diff <= LOGITS_TOL and pred_diff <= LOGITS_TOL):
        raise Failed(f"kernel path differs from plain path: logits {diff}, predict {pred_diff}")
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

    phase_card()
    phase_build()
    summary = phase_kernels(dev)
    launches = phase_serve(dev)

    sources = {
        "pair_bias_attention": ("mmdti_tpu_torch/csrc/pair_bias_attention.cu",
                                "mmdti_tpu/ops/pallas_attention.py:166"),
        "masked_attention": ("mmdti_tpu_torch/csrc/masked_attention.cu",
                             "mmdti_tpu/ops/pallas_attention.py:590"),
        "gbf_proj": ("mmdti_tpu_torch/csrc/gbf_proj.cu", "mmdti_tpu/ops/pallas_gbf.py:117"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
